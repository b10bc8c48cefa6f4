"""The port's precision modes on the CPU against ``roko_tpu``'s
(``tests/test_precision.py``): ``compute_dtype="bfloat16"`` and
``quantize="int8"``, apart and together, for ``kind="gru"`` and
``"lingru"`` at tiny widths (embed 8, read MLP 8->4, hidden 16, 2
layers; random JAX weights through the weights bridge).

- config and CLI validation, and ``"auto"`` resolving to float32 off a
  TPU, as in the reference;
- ``quantize_params`` bit-equal to the reference's (q and scale, after
  the layout transpose), ``maybe_quantize`` idempotent, the bridge
  carrying int8 weights both ways;
- int8 with float32 compute: logits at the float32 bar (rtol 1e-4,
  atol 1e-5) with argmax exact, and ``inference`` / ``polish --staged``
  FASTA byte-equal to the reference's with ``--quantize int8``;
- bfloat16: the plain recurrences (the kernels' CPU stand-ins) against
  the reference's Pallas layers in interpret mode (atol 1e-2), and the
  model's logits against the reference's bf16 Pallas route, the route
  the port's kernels follow: closer to it than that route is to the
  reference's float32 logits. On the CPU the reference's gru ignores
  ``use_pallas`` and its lingru needs ``ROKO_PALLAS_INTERPRET=1``, so the
  tests patch the route in (no file of the JAX package changes);
- the streamed bfloat16 polish byte-equal to the staged one.
"""

import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import roko_tpu.models.gru as ref_gru
import roko_tpu.models.pallas_gru as ref_pallas_gru
from roko_tpu import config as jconfig
from roko_tpu.config import RokoConfig as JaxRokoConfig
from roko_tpu.features.pipeline import run_features as ref_run_features
from roko_tpu.infer import polish_to_fasta as ref_polish_to_fasta
from roko_tpu.models import RokoModel as JaxRokoModel
from roko_tpu.models import quant as ref_quant
from roko_tpu.models.pallas_lingru import bidir_lingru_layer_pallas
from roko_tpu_torch import cli, kernels
from roko_tpu_torch.config import (
    COMPUTE_DTYPES,
    QUANTIZE_MODES,
    ModelConfig,
    TrainConfig,
    default_compute_dtype,
)
from roko_tpu_torch.infer import use_float32_matmuls
from roko_tpu_torch.models import fused_gru as fg
from roko_tpu_torch.models import fused_lingru as fl
from roko_tpu_torch.models import quant
from roko_tpu_torch.models.convert import jax_from_state_dict, state_dict_from_jax
from roko_tpu_torch.models.model import RokoModel
from roko_tpu_torch.training.data import InMemoryDataset
from roko_tpu_torch.training.loop import check_trainable, train
from tests.test_torch_polish import SMALL, project  # noqa: F401  (module fixture)
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
KINDS = ("gru", "lingru")
TINY = dict(embed_dim=8, read_mlp=(8, 4), hidden_size=16, num_layers=2)
#: int8 weights dequantize to float32 exactly as the reference's do, so
#: the logits meet the float32 bar of tests/test_torch_model.py
RTOL, ATOL = 1e-4, 1e-5
#: a bf16 layer of the plain recurrence against the reference's Pallas
#: layer in interpret mode: both round xp and every h to bf16 (8 bits of
#: mantissa, 4e-3 relative) and sum the step product in f32 in another
#: order, so one rounding may land a bf16 ulp apart
BF16_LAYER_ATOL = 1e-2
#: bf16 route -> (compute_dtype, quantize)
MODES = {"bfloat16": ("bfloat16", None), "bfloat16+int8": ("bfloat16", "int8")}


def _jax_cfg(kind, **kw):
    return jconfig.ModelConfig(kind=kind, **TINY, **kw)


def _port_cfg(kind, **kw):
    return ModelConfig(kind=kind, **TINY, **kw)


def _jax_params(kind, seed=0):
    return jax.tree.map(np.asarray, JaxRokoModel(_jax_cfg(kind)).init(jax.random.PRNGKey(seed)))


def _windows(n, seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 12, (n, 200, 90), dtype=np.uint8)


def _port_logits(cfg, sd, x):
    model = RokoModel(cfg)
    model.load_state_dict(sd, strict=True)
    quant.maybe_quantize(model)
    with torch.inference_mode():
        return model(torch.from_numpy(x)).numpy()


# -- config + CLI validation --------------------------------------------------


def test_precision_constants_and_defaults_match_reference():
    assert COMPUTE_DTYPES == jconfig.COMPUTE_DTYPES
    assert QUANTIZE_MODES == jconfig.QUANTIZE_MODES
    ref, port = jconfig.ModelConfig(), ModelConfig()
    assert (port.compute_dtype, port.quantize) == (ref.compute_dtype, ref.quantize) == ("auto", None)


def test_config_rejects_unknown_compute_dtype():
    with pytest.raises(ValueError, match="unknown compute_dtype"):
        ModelConfig(compute_dtype="float16")


def test_config_rejects_unknown_quantize_mode():
    with pytest.raises(ValueError, match="unknown quantize mode"):
        ModelConfig(quantize="int4")


def test_config_rejects_transformer_quantize():
    with pytest.raises(ValueError, match="transformer variant has no int8"):
        ModelConfig(kind="transformer", quantize="int8")


@pytest.mark.parametrize("backend", ["tpu", "cpu", "gpu", "cuda", None])
def test_default_compute_dtype_policy(backend):
    """The reference's policy: bf16 on a TPU only; the port runs on cuda
    or cpu, where "auto" is float32."""
    want = "bfloat16" if backend == "tpu" else "float32"
    assert default_compute_dtype(backend) == want
    if backend is not None:
        assert jconfig.default_compute_dtype(backend) == want
    assert ModelConfig().resolve(backend).compute_dtype == want
    # explicit dtypes never re-resolve
    assert ModelConfig(compute_dtype="bfloat16").resolve(backend).compute_dtype == "bfloat16"


def test_model_resolves_auto_to_float32():
    model = RokoModel(_port_cfg("gru"))
    assert model.cfg.compute_dtype == "float32"
    assert model.compute_dtype == torch.float32


_ARGV = {
    "inference": ["inference", "d.hdf5", "ckpt", "out.fa"],
    "polish": ["polish", "r.fa", "x.bam", "ckpt", "o.fa"],
    "polish_staged": ["polish", "r.fa", "x.bam", "ckpt", "o.fa", "--staged"],
}


@pytest.mark.parametrize("command", list(_ARGV))
def test_cli_precision_flags_reach_config(command):
    parser = cli.build_parser()
    args = parser.parse_args(_ARGV[command] + ["--quantize", "int8", "--compute-dtype",
                                               "bfloat16", "--model-kind", "lingru"])
    cfg = cli._model_config(args)
    assert (cfg.kind, cfg.compute_dtype, cfg.quantize) == ("lingru", "bfloat16", "int8")
    args = parser.parse_args(_ARGV[command] + ["--quantize", "none"])
    assert cli._model_config(args).quantize is None
    assert cli._model_config(parser.parse_args(_ARGV[command])).compute_dtype == "auto"


@pytest.mark.parametrize("dtype", list(COMPUTE_DTYPES))
def test_cli_compute_dtype_choices(dtype):
    args = cli.build_parser().parse_args(_ARGV["inference"] + ["--compute-dtype", dtype])
    assert cli._model_config(args).compute_dtype == dtype


@pytest.mark.parametrize("flag", [["--compute-dtype", "float16"], ["--quantize", "int4"]])
def test_cli_refuses_unknown_precision(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.build_parser().parse_args(_ARGV["inference"] + flag)
    assert exc.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


@pytest.mark.parametrize("field,value,message", [
    ("quantize", "int8", "inference-only conversion"),
    # bf16 trains since its backward kernels were ported; the id is the
    # one this case had while train refused bf16
    pytest.param("compute_dtype", "bfloat16", None,
                 id="compute_dtype-bfloat16-bfloat16 backward kernels"),
])
def test_train_refuses_int8_and_bf16(tmp_path, capsys, field, value, message):
    """``train`` refuses int8 with the reference's message, on the command
    line (rc 2) and as a function, before it touches the output directory;
    bf16 passes the command line's check and trains."""
    flag = ["--" + field.replace("_", "-"), value]
    argv = ["train", str(tmp_path / "x.hdf5"), str(tmp_path / "out"), *flag, *SMALL]
    cfg = _port_cfg("gru", **{field: value})
    if message is None:
        parser = cli.build_parser()
        assert cli._model_config(parser.parse_args(argv)).compute_dtype == "bfloat16"
        check_trainable(cfg)
        X = _windows(8)
        result = train(InMemoryDataset(X, (X.sum(axis=1) % 5).astype(np.int32)),
                       str(tmp_path / "out"), model_cfg=cfg,
                       train_cfg=TrainConfig(batch_size=4, epochs=1), device="cpu",
                       log=lambda s: None)
        assert result.step == 2 and np.isfinite(result.history[0]["train_loss"])
        assert (tmp_path / "out" / "latest").is_dir()
        return
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 2
    assert message in capsys.readouterr().err
    with pytest.raises(ValueError, match=message):
        train(str(tmp_path / "x.hdf5"), str(tmp_path / "out"), model_cfg=cfg, device="cpu")
    assert not (tmp_path / "out").exists()


def test_model_in_training_mode_refuses_bf16():
    """Training mode refuses an int8 model (an inference-only conversion)
    and runs a bf16 one: float32 logits, and float32 gradients on every
    parameter."""
    x = torch.from_numpy(_windows(1))
    model = RokoModel(_port_cfg("gru", compute_dtype="bfloat16")).train()
    logits = model(x)
    assert logits.dtype == torch.float32 and logits.shape == (1, 90, 5)
    logits.sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in model.parameters())
    int8 = quant.maybe_quantize(RokoModel(_port_cfg("gru", quantize="int8"))).train()
    with pytest.raises(ValueError, match="inference-only conversion"):
        int8(x)


def test_matmul_policy_turns_off_bf16_reduced_reduction(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction",
                        True)
    use_float32_matmuls()
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


# -- quantization math ------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_params_bit_equal_to_reference(kind):
    """q and scale of every target, bit for bit, after the transpose; and
    the bridge carries the reference's int8 tree across and back."""
    params = _jax_params(kind)
    want_tree = ref_quant.quantize_params(params, _jax_cfg(kind, quantize="int8"))
    want = state_dict_from_jax(jax.tree.map(np.asarray, want_tree))
    got = quant.quantize_params(state_dict_from_jax(params), _port_cfg(kind, quantize="int8"))
    assert list(got) == list(want)
    n_int8 = 0
    for name, t in got.items():
        assert t.dtype == want[name].dtype and torch.equal(t, want[name]), name
        n_int8 += t.dtype == torch.int8
    assert n_int8 == 3 + 2 * 2 * 2  # fc1, fc2, fc4; 2 matrices x 2 directions x 2 layers
    back = jax_from_state_dict(got)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                 jax.tree_util.tree_flatten_with_path(want_tree)[0]):
        assert a.dtype == b.dtype and np.array_equal(a, np.asarray(b)), path


def test_quantize_weight_per_channel_scales_and_zero_channel():
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((6, 20)) * np.array([0.1, 1.0, 10.0, 0.01, 5.0, 0.0])[:, None])
    w = torch.from_numpy(w.astype(np.float32))
    qw = quant.quantize_weight(w)
    ref = ref_quant.quantize_weight(jnp.asarray(w.numpy().T))
    assert torch.equal(qw["q"], torch.from_numpy(np.asarray(ref["q"]).T.copy()))
    assert torch.equal(qw["scale"], torch.from_numpy(np.array(ref["scale"])))
    assert qw["q"][5].abs().max() == 0 and qw["scale"][5] == 1.0 / quant.QMAX
    assert qw["q"].abs().max() == 127


def test_maybe_quantize_is_idempotent_and_conversion_only():
    sd = state_dict_from_jax(_jax_params("gru"))
    off = RokoModel(_port_cfg("gru"))
    off.load_state_dict(sd)
    assert quant.maybe_quantize(off) is off and not quant.is_quantized(off.state_dict())
    model = RokoModel(_port_cfg("gru", quantize="int8"))
    model.load_state_dict(sd)
    quant.maybe_quantize(model)
    once = {k: v.clone() for k, v in model.state_dict().items()}
    assert quant.is_quantized(once)
    quant.maybe_quantize(model)
    again = model.state_dict()
    assert list(again) == list(once) and all(torch.equal(again[k], once[k]) for k in once)
    assert not any(quant.is_target(n) for n, _ in model.named_parameters())
    want = quant.quantize_params(sd, model.cfg)
    assert sorted(once) == sorted(want) and all(torch.equal(once[k], want[k]) for k in want)


def test_dequantize_params_matches_reference():
    params = _jax_params("lingru")
    tree = ref_quant.quantize_params(params, _jax_cfg("lingru", quantize="int8"))
    want = state_dict_from_jax(jax.tree.map(np.asarray, ref_quant.dequantize_params(tree)))
    got = quant.dequantize_params(state_dict_from_jax(jax.tree.map(np.asarray, tree)))
    assert list(got) == list(want)
    for name, t in got.items():
        assert torch.equal(t, want[name]), name


# -- int8 with float32 compute ------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_int8_logits_match_reference(kind):
    params = _jax_params(kind)
    cfg = _jax_cfg(kind, quantize="int8")
    x = _windows(3)
    want = np.asarray(JaxRokoModel(cfg).apply(ref_quant.maybe_quantize(params, cfg), x))
    got = _port_logits(_port_cfg(kind, quantize="int8"), state_dict_from_jax(params), x)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    # the reference's own int8 tree, carried over the bridge, gives the same bits
    model = RokoModel(_port_cfg(kind, quantize="int8"))
    quant.maybe_quantize(model)
    model.load_state_dict(state_dict_from_jax(jax.tree.map(
        np.asarray, ref_quant.quantize_params(params, cfg))), strict=True)
    with torch.inference_mode():
        assert np.array_equal(model(torch.from_numpy(x)).numpy(), got)
    # and int8 moved the logits: the quantization really ran
    f32 = _port_logits(_port_cfg(kind), state_dict_from_jax(params), x)
    assert np.abs(f32 - got).max() > 1e-5


@pytest.mark.parametrize("command", ["inference", "polish_staged"])
@pytest.mark.parametrize("kind", KINDS)
def test_int8_fasta_byte_equal_to_reference(project, tmp_path, kind, command):  # noqa: F811
    """``--quantize int8`` through the port's CLI against the reference's
    staged polish of the same features with ``quantize="int8"``."""
    h5, out = str(tmp_path / "f.hdf5"), tmp_path / "port.fasta"
    ref_run_features(project["draft_fasta"], project["reads_bam"], h5, seed=0,
                     log=lambda *a: None)
    # the project's weights: default widths, hidden 16, 2 layers
    cfg = jconfig.ModelConfig(kind=kind, hidden_size=16, num_layers=2, quantize="int8")
    ref_polish_to_fasta(h5, project["params"][kind], str(tmp_path / "ref.fasta"),
                        JaxRokoConfig(model=cfg), batch_size=32, log=lambda *a: None)
    flags = ["--quantize", "int8", "--model-kind", kind, "--b", "32", *SMALL]
    if command == "inference":
        argv = ["inference", h5, project["pth"][kind], str(out), *flags]
    else:
        argv = ["polish", project["draft_fasta"], project["reads_bam"], project["pth"][kind],
                str(out), "--staged", "--t", "2", *flags]
    assert cli.main(argv) == 0
    want = (tmp_path / "ref.fasta").read_bytes()
    assert len(want) > 3000
    assert out.read_bytes() == want


# -- bfloat16 -----------------------------------------------------------------


def _bf16_layer(rng, kind, in_size, H):
    if kind == "gru":
        b = 1.0 / np.sqrt(H)
        shapes = {"w_ih": (in_size, 3 * H), "w_hh": (H, 3 * H), "b_ih": (3 * H,),
                  "b_hh": (3 * H,)}
    else:
        b = 1.0 / np.sqrt(in_size)
        shapes = {"w_zx": (in_size, H), "w_cx": (in_size, H), "b_z": (H,), "b_c": (H,)}
    return {d: {k: rng.uniform(-b, b, s).astype(np.float32) for k, s in shapes.items()}
            for d in ("fwd", "bwd")}


@pytest.mark.parametrize("B,T,IN,H", [(3, 9, 12, 16), (5, 30, 24, 8)])
@pytest.mark.parametrize("kind", KINDS)
def test_bf16_plain_layer_matches_reference_pallas_interpret(kind, B, T, IN, H):
    """One layer in bf16: the plain recurrence (the kernels' CPU stand-in)
    against the reference's Pallas layer in interpret mode with bf16
    params and input; odd batches exercise the reference's row padding."""
    rng = np.random.default_rng(B * 100 + H)
    layer = _bf16_layer(rng, kind, IN, H)
    x = rng.standard_normal((B, T, IN)).astype(np.float32)
    jl = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), layer)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tl = jax.tree.map(lambda a: torch.from_numpy(a).to(torch.bfloat16), layer)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    if kind == "gru":
        want = ref_pallas_gru.fused_bidir_layer(jl, jx, interpret=True,
                                                compute_dtype=jnp.bfloat16)
        got = fg.fused_bidir_layer(tl, tx, recurrence=fg.gru_recurrence_plain)
    else:
        want = bidir_lingru_layer_pallas(jl, jx, interpret=True)
        got = fl.bidir_lingru_layer(tl, tx, scan=fl.lingru_scan_plain)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=BF16_LAYER_ATOL, rtol=0)


def test_bf16_plain_recurrences_keep_an_f32_carry():
    """The plain loops in bf16: h rounded to bf16 for the product and the
    output, the carry in f32, and the CPU wrappers route bf16 to them."""
    rng = np.random.default_rng(2)
    xp = torch.from_numpy(rng.standard_normal((2, 6, 2 * 3 * 8)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-0.3, 0.3, (2, 8, 24)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-0.3, 0.3, (2, 24)).astype(np.float32))
    bf = [t.to(torch.bfloat16) for t in (xp, w, b)]
    got = fg.gru_recurrence_plain(*bf)
    assert got.dtype == torch.bfloat16 and torch.equal(fg.gru_recurrence(*bf), got)
    # the loop of the docstring, by hand, for direction 0
    x, wf, bf32 = (t.float() for t in bf)
    h = torch.zeros(2, 8)
    for t in range(6):
        hp = h.to(torch.bfloat16).float() @ wf[0] + bf32[0]
        xt = x[:, t, :24]
        r = torch.sigmoid(xt[:, :8] + hp[:, :8])
        z = torch.sigmoid(xt[:, 8:16] + hp[:, 8:16])
        n = torch.tanh(xt[:, 16:] + r * hp[:, 16:])
        h = (1 - z) * n + z * h
        torch.testing.assert_close(got[:, t, :8].float(), h.to(torch.bfloat16).float(),
                                   atol=0, rtol=0)
    p = torch.from_numpy(rng.standard_normal((3, 7, 4 * 5)).astype(np.float32)).to(torch.bfloat16)
    h = fl.lingru_scan_plain(p)
    assert h.dtype == torch.bfloat16 and torch.equal(fl.lingru_scan(p), h)
    torch.testing.assert_close(h, fl.lingru_scan_plain(p.float()).to(torch.bfloat16),
                               atol=0, rtol=0)


def bf16_route_logits(mp, kind, mode, n_windows=4):
    """(the port's logits, the reference's on its Pallas route in ``mode``,
    the reference's on that route in float32 with the same quantize) on
    the same windows and weights. ``mp`` (a ``pytest.MonkeyPatch``) puts
    the reference on its Pallas route in interpret mode."""
    dtype, quantize = MODES[mode]
    if kind == "gru":
        mp.setattr(ref_gru, "_pallas_backend", lambda: True)
        mp.setattr(ref_pallas_gru, "bidir_gru_stack_pallas", functools.partial(
            ref_pallas_gru.bidir_gru_stack_pallas, interpret=True))
    else:
        mp.setenv("ROKO_PALLAS_INTERPRET", "1")
    params = _jax_params(kind)
    x = _windows(n_windows)

    def ref(compute_dtype):
        cfg = _jax_cfg(kind, compute_dtype=compute_dtype, quantize=quantize, use_pallas=True)
        return np.asarray(JaxRokoModel(cfg).apply(ref_quant.maybe_quantize(params, cfg), x))

    got = _port_logits(_port_cfg(kind, compute_dtype=dtype, quantize=quantize),
                       state_dict_from_jax(params), x)
    return got, ref(dtype), ref("float32")


def clear_columns(want, tol):
    """Columns whose top-two logits lie more than ``tol`` apart."""
    top2 = np.sort(want, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > tol


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", KINDS)
def test_bf16_logits_closer_to_reference_pallas_route_than_it_is_to_f32(kind, mode,
                                                                        monkeypatch):
    got, want, f32 = bf16_route_logits(monkeypatch, kind, mode)
    route_to_f32 = np.abs(want - f32).max()
    d = np.abs(got - want).max()
    assert route_to_f32 > 1e-4, "bf16 did not move the reference's logits"
    assert d < route_to_f32, (d, route_to_f32)
    # argmax where the reference's top-two gap exceeds the logit tolerance
    clear = clear_columns(want, route_to_f32)
    print(f"{kind} {mode}: max |d| {d:.3g} vs route-to-f32 {route_to_f32:.3g}; "
          f"{int((~clear).sum())} of {clear.size} columns excluded from the argmax check")
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_stream_polish_byte_equal_to_staged(project, tmp_path, kind):  # noqa: F811
    """The default (streamed) polish in bf16 writes the bytes of the
    staged polish in bf16: a window's class ids do not depend on the
    other rows of its padded batch in bf16 either."""
    flags = ["--compute-dtype", "bfloat16", "--model-kind", kind, "--b", "32", "--t", "2",
             *SMALL]
    base = [project["draft_fasta"], project["reads_bam"], project["pth"][kind]]
    streamed, staged = tmp_path / "stream.fasta", tmp_path / "staged.fasta"
    assert cli.main(["polish", *base, str(streamed), *flags]) == 0
    if kind == "gru":  # once through the module entry point, as a user runs it
        proc = subprocess.run(
            [sys.executable, "-m", "roko_tpu_torch", "polish", *base, str(staged), "--staged",
             *flags], capture_output=True, text=True, timeout=300, cwd=str(ROOT))
        assert proc.returncode == 0, proc.stderr
    else:
        assert cli.main(["polish", *base, str(staged), "--staged", *flags]) == 0
    assert len(staged.read_bytes()) > 3000
    assert streamed.read_bytes() == staged.read_bytes()


# -- what the kernels take ------------------------------------------------------


def test_kernel_dtypes_and_bf16_plans():
    assert kernels.DTYPES["gru_fwd_bf16"] == kernels.DTYPES["lingru_fwd_bf16"] == torch.bfloat16
    assert kernels.DTYPES["gru_fwd"] == kernels.DTYPES["gru_bwd"] == torch.float32
    xp = torch.zeros(2, 3, 24)
    with pytest.raises(ValueError, match="gru_fwd_bf16 takes bfloat16; xp is torch.float32"):
        kernels.check_inputs("gru_fwd_bf16", xp=xp)
    with pytest.raises(ValueError, match="gru_fwd takes float32; xp is torch.bfloat16"):
        kernels.check_inputs("gru_fwd", xp=xp.to(torch.bfloat16))
    # gru_fwd_bf16: W_hh[s] in registers, a warp for each 16 units; in shared
    # memory the 8-step xp ring of rows of 3H + 8 and the double-buffered h
    # of the 8-row mma tile, rows of 128 + 8
    f32 = fg.fwd_plan(512, 90, 128, 2, 132)
    bf16 = fg.fwd_plan(512, 90, 128, 2, 132, dtype=torch.bfloat16)
    assert (f32["rows"], f32["smem_bytes"]) == (8, 4 * (128 * 388 + 2 * 8 * 128))
    assert (bf16["rows"], bf16["blocks"], bf16["threads"]) == (8, 128, 256)
    assert bf16["smem_bytes"] == 2 * (8 * 8 * 392 + 2 * 8 * 136) == 54_528
    at_128 = fg.fwd_plan(128, 90, 128, 2, 132, dtype=torch.bfloat16)
    assert (at_128["rows"], at_128["blocks"], at_128["threads"]) == (2, 128, 256)
    assert at_128["smem_bytes"] == 2 * (8 * 2 * 392 + 2 * 8 * 136)
    assert fg.fwd_plan(9, 33, 512, 2, 132, dtype=torch.bfloat16)["variant"] == "streaming"
    # lingru_fwd_bf16's streaming variant, for the shapes its staged one
    # does not take, launches as the f32 streaming one does
    plan = fl.scan_plan(512, 90, 128, 132, "fwd", variant="streaming")
    assert (plan["blocks"], plan["threads"]) == (1024, 128)
    assert fl.scan_plan(512, 90, 128, 132, "fwd", variant="streaming",
                        dtype=torch.bfloat16) == plan
    # the inference shape launches lingru_fwd_bf16 staged: a ring of bf16
    # runs, f32 gate buffers, 384 threads a block, 3 blocks an SM
    staged = fl.scan_plan(512, 90, 128, 132, "fwd", dtype=torch.bfloat16)
    steps, stages = fl.SCAN_DEFAULT_BF16["fwd"]
    assert (staged["variant"], staged["steps"], staged["stages"]) == ("staged", steps, stages)
    assert (staged["blocks"], staged["threads"], staged["waves"]) == (1024, 384, 3)
    assert staged["smem_bytes"] == steps * 128 * (2 * stages * 2 + 4 * 2 * 2)
    assert fl.scan_plan(5, 90, 12, 132, "fwd", dtype=torch.bfloat16)["variant"] == "streaming"


@pytest.mark.parametrize("rows", fg.RESIDENT_ROWS)
@pytest.mark.parametrize("H", [4, 12, 16, 40, 128])
def test_bf16_fwd_plan_at_every_rows(H, rows):
    """gru_fwd_bf16's resident launch: a warp for each 16 units (at most 8),
    shared memory for the xp ring and the h tile well within an H100
    block's 227 KB, and the unforced plan one wave of blocks at the
    inference and the train batch."""
    plan = fg.fwd_plan(512, 90, H, 2, 132, rows=rows, dtype=torch.bfloat16)
    assert plan["variant"] == "resident" and plan["rows"] == rows
    assert plan["threads"] == 32 * -(-H // 16) <= 256
    # laid out for the widest H whatever H is: ring rows of 3 x 128 + 8,
    # h rows of 128 + 8
    assert plan["smem_bytes"] == 2 * (8 * rows * 392 + 2 * 8 * 136) <= 232_448
    for B in (512, 128):
        unforced = fg.fwd_plan(B, 90, H, 2, 132, dtype=torch.bfloat16)
        assert unforced["blocks"] <= 132
        assert unforced["threads"] == plan["threads"]
