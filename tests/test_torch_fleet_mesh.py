"""A fleet worker's session over its card slice: ``parallel.mesh.
fleet_worker_ranks`` / ``fleet_worker_rank_envs`` and the supervisor as the
launcher of each worker's k ranks (``serve/fleet.py``, ``serve/supervisor.py``).

- the k overlays of a worker for several (worker, fleet, slice, mesh)
  tuples: the slice's ``CUDA_VISIBLE_DEVICES`` is the reference's GPU
  overlay (``roko_tpu.parallel.mesh.fleet_worker_env``), every rank gets
  ``ROKO_COORDINATOR``, ``ROKO_NUM_PROCESSES=k`` and its
  ``ROKO_PROCESS_ID``, and nothing else: the ranks choose their backend
  from the cards they swap (``distributed.choose_backend``: gloo where
  they share one, NCCL on a card each, an explicit NCCL on shared cards
  refused);
- a k that the grid, the model or the ladder cannot take is refused
  before anything spawns, with ``mesh_shape``'s, ``check_divisible``'s or
  ``validate_ladder``'s message;
- the supervision machinery over stub ranks: a worker of k processes, one
  of them SIGKILLed, is one death, all k are restarted, and a drain leaves
  none; a rank whose parent is killed outright exits;
- a real CPU fleet of one worker with ``devices_per_worker=2``
  (``supervisor.boot_fleet`` in this process, its worker two ``python -m
  roko_tpu_torch serve --device cpu`` gloo ranks): replies byte-equal to a
  one-rank worker's, the port's staged stitch and ``roko_tpu``'s
  in-process server on the same weights; no rank outlives the drain, and
  each rank's launch file (written at its exit) counts the same
  dispatches. Through ``serve --workers 1 --dp 2`` as a process
  (``slow``): the follower's SIGKILL restarts the worker once,
  both ranks anew, the replies stay equal, and SIGTERM drains it to exit
  0 with no rank left.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from roko_tpu_torch.config import FleetConfig, MeshConfig, ModelConfig, RokoConfig, ServeConfig
from roko_tpu_torch.parallel import mesh as mesh_mod
from roko_tpu_torch.parallel.mesh import fleet_worker_rank_envs, fleet_worker_ranks
from roko_tpu_torch.serve.client import PolishClient
from roko_tpu_torch.serve.fleet import READY, Fleet, WorkerLaunchSpec
from roko_tpu_torch.serve.supervisor import worker_ranks
from tests.test_torch_fleet import STUB, fast_fleet_cfg, get_json, wait_until
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
COORD = "127.0.0.1:29999"


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:  # an unreaped child shows as a zombie
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


# -- the overlays --------------------------------------------------------------


@pytest.mark.parametrize("wid,n,k,mesh,backend,visible,want_k", [
    (0, 2, 2, MeshConfig(), "cuda", 4, 2),        # a 2-card slice: 2 ranks
    (1, 2, 2, MeshConfig(), "cuda", 4, 2),
    (3, 4, 2, MeshConfig(dp=1, tp=2), "cuda", 8, 2),
    (1, 3, 1, MeshConfig(), "cuda", 3, 1),        # one card a worker: a plain process
    (0, 2, 0, MeshConfig(dp=2), "cuda", 1, 2),    # shared card: dp 2 on the one card
    (1, 2, 0, MeshConfig(), "cuda", 4, 4),        # shared cards: dp -1 absorbs them all
    (0, 1, 0, MeshConfig(), "cuda", 1, 1),
    (0, 1, 2, MeshConfig(), "cpu", 1, 2),         # the CPU: k gloo ranks
    (0, 2, 0, MeshConfig(dp=2, sp=2), "cpu", 1, 4),
    (1, 2, 0, MeshConfig(), "cpu", 1, 1),
])
def test_worker_rank_envs(wid, n, k, mesh, backend, visible, want_k):
    """k overlays, each the slice the reference pins plus ``ROKO_*``."""
    from roko_tpu.parallel.mesh import fleet_worker_env as ref_env

    assert fleet_worker_ranks(k, mesh, backend, n_visible=visible) == want_k
    envs = fleet_worker_rank_envs(wid, n, k, mesh, COORD, backend=backend, n_visible=visible)
    assert len(envs) == want_k
    slice_env = {} if backend == "cpu" else ref_env(wid, n, k, backend="gpu")
    for r, env in enumerate(envs):
        assert env.get("CUDA_VISIBLE_DEVICES") == slice_env.get("CUDA_VISIBLE_DEVICES")
        if want_k == 1:
            assert env == slice_env
            continue
        assert (env["ROKO_COORDINATOR"], env["ROKO_NUM_PROCESSES"], env["ROKO_PROCESS_ID"]) \
            == (COORD, str(want_k), str(r))
        assert set(env) - {"CUDA_VISIBLE_DEVICES"} \
            == {"ROKO_COORDINATOR", "ROKO_NUM_PROCESSES", "ROKO_PROCESS_ID"}


def test_worker_ranks_count_visible_cards_without_opening_them(monkeypatch):
    """Shared cards and a ``dp=-1`` grid: k is the visible cards, read from
    ``CUDA_VISIBLE_DEVICES`` or counted by ``torch.cuda.device_count()`` in
    a child process (this one opens no device file), the one counter that
    ``--workers auto`` uses too."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2")
    assert fleet_worker_ranks(0, MeshConfig(), "cuda") == 3
    assert fleet_worker_ranks(0, MeshConfig(tp=-1, dp=1), "cuda") == 3
    assert len(fleet_worker_rank_envs(0, 1, 0, MeshConfig(dp=6), COORD)) == 6
    # without it, a child process counts the machine's cards: none here,
    # so a worker of shared cards is one plain process
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    mesh_mod._child_device_count.cache_clear()
    assert mesh_mod.visible_device_count("cuda") == 0
    assert fleet_worker_rank_envs(0, 1, 0, MeshConfig(), COORD) == [{}]


@pytest.mark.parametrize("cards,asked,want", [
    (["h:0", "h:1"], None, "nccl"),               # a card each: NCCL
    (["h:0", "g:0"], None, "nccl"),               # one card on each of two hosts
    (["h:0", "h:0"], None, "gloo"),               # a worker's two ranks on one card
    (["h:0", "h:1", "h:0", "h:1"], None, "gloo"),
    (["h:0", "h:0"], "gloo", "gloo"),
    (["h:0", "h:1"], "gloo", "gloo"),             # the caller's choice stands
    (["h:0", "h:0"], "nccl", None),               # NCCL on a shared card: refused
])
def test_ranks_choose_their_backend(cards, asked, want):
    """The ranks' own card ids decide the backend: no launcher names it."""
    from roko_tpu_torch.parallel import distributed

    if want is None:
        with pytest.raises(ValueError, match="share card h:0.*NCCL refuses"):
            distributed.choose_backend(cards, asked)
    else:
        assert distributed.choose_backend(cards, asked) == want


@pytest.mark.parametrize("cfg,match", [
    (RokoConfig(mesh=MeshConfig(dp=1), fleet=FleetConfig(workers=1, devices_per_worker=2)),
     "mesh \\[1, 1, 1\\] wants 1 devices, have 2"),
    (RokoConfig(mesh=MeshConfig(tp=4), fleet=FleetConfig(workers=1, devices_per_worker=2)),
     "not divisible by fixed axes product 4"),
    (RokoConfig(model=ModelConfig(kind="transformer", num_heads=3), mesh=MeshConfig(tp=2),
                fleet=FleetConfig(workers=1, devices_per_worker=2)),
     "num_heads 3 not divisible by tp=2"),
    (RokoConfig(serve=ServeConfig(ladder=(8, 13)),
                fleet=FleetConfig(workers=2, devices_per_worker=2)),
     "ladder rungs \\[13\\] are not positive multiples of the mesh dp axis \\(dp=2\\)"),
])
def test_worker_ranks_refuses_what_does_not_fit(cfg, match):
    with pytest.raises(ValueError, match=match):
        worker_ranks(cfg, "cpu")


@pytest.mark.parametrize("grid", [("--devices-per-worker", "2"), ("--dp", "2")])
def test_cli_refuses_a_slice_the_ladder_cannot_take_before_spawning(tmp_path, capsys, grid):
    """``serve --workers 1 --devices-per-worker 2 --ladder 5`` (or ``--dp 2``
    on shared cards: the supervisor joins no grid itself, its ``--dp`` is
    its workers'): exit 1 naming the ladder, and no runtime directory
    (nothing spawned)."""
    from roko_tpu_torch.cli import main

    rt = tmp_path / "rt"
    cfg = tmp_path / "cfg.json"
    cfg.write_text(RokoConfig(fleet=FleetConfig(runtime_dir=str(rt))).to_json())
    rc = main(["serve", str(tmp_path / "none.pth"), "--config", str(cfg), "--workers", "1",
               *grid, "--ladder", "5", "--device", "cpu"])
    assert rc == 1
    assert "ladder rungs [5] are not positive multiples" in capsys.readouterr().err
    assert not rt.exists()


# -- supervision of k ranks, over stubs ----------------------------------------


def _stub_ranks(k):
    """A spec whose rank 0 is the stub worker (binds, answers) and whose
    followers are idle processes, k in all."""

    def command(wid, announce):
        if announce is None:
            return [sys.executable, "-c", "import time; time.sleep(600)"]
        return [sys.executable, STUB, "--announce", announce]

    return WorkerLaunchSpec(command, ranks=lambda wid: [{"RANK_OF": str(r)} for r in range(k)])


def _stub_fleet(tmp_path, k=2):
    fleet = Fleet(RokoConfig(serve=ServeConfig(max_queue=8),
                             fleet=fast_fleet_cfg(1, term_grace_s=0.5)),
                  lambda *_: [], runtime_dir=str(tmp_path / "fleet"), log=lambda m: None)
    fleet.install_boot_spec(_stub_ranks(k))
    return fleet


@pytest.mark.parametrize("victim", [1, 0])
def test_one_rank_death_restarts_the_whole_worker_once(tmp_path, victim):
    """SIGKILL one rank of a 3-rank worker: the others are killed, the
    death counts once, all three start anew, and the drain leaves none."""
    fleet = _stub_fleet(tmp_path, k=3)
    fleet.start()
    try:
        w = fleet.workers[0]
        wait_until(lambda: w.state == READY, msg="worker ready")
        first = [p.pid for p in w.procs]
        assert len(first) == 3 and fleet.summary()["workers"]["0"]["ranks"] == 3
        w.procs[victim].kill()
        wait_until(lambda: w.state == READY and w.restarts == 1 and w.alive(),
                   msg="all ranks restarted")
        assert fleet.counter("restarts") == 1 and w.attempt <= 1
        assert not any(_alive(pid) for pid in first)
        again = [p.pid for p in w.procs]
        assert len(again) == 3 and not set(again) & set(first)
    finally:
        fleet.stop()
    assert not any(_alive(pid) for pid in first + again)


def test_drain_stops_a_leader_then_its_followers(tmp_path):
    """SIGTERM goes to rank 0 alone (it drains and would send the stop op);
    followers that outlive it are killed, so none is left."""
    fleet = _stub_fleet(tmp_path, k=2)
    fleet.start()
    w = fleet.workers[0]
    wait_until(lambda: w.state == READY, msg="worker ready")
    pids = [p.pid for p in w.procs]
    fleet.stop(rolling=False)
    assert [p.returncode for p in w.procs][0] == 0  # the stub drained on SIGTERM
    assert not any(_alive(pid) for pid in pids)


def test_a_rank_exits_when_its_supervisor_is_killed(tmp_path):
    """A fleet worker rank watches its parent: a supervisor killed outright
    (SIGKILL, no drain) leaves no rank behind."""
    out = tmp_path / "child.pid"
    code = ("import subprocess, sys\n"
            "p = subprocess.Popen([sys.executable, '-c', 'import sys, time; "
            "from roko_tpu_torch.cli import _exit_with_parent; _exit_with_parent(); "
            "open(sys.argv[1], \"w\").write(\"up\"); time.sleep(600)', sys.argv[1]])\n"
            "print(p.pid, flush=True)\n"
            "import time; time.sleep(600)\n")
    parent = subprocess.Popen([sys.executable, "-c", code, str(out)], cwd=str(ROOT),
                              stdout=subprocess.PIPE, text=True)
    child = int(parent.stdout.readline())
    try:
        wait_until(out.exists, timeout=60, msg="the rank up")
        assert _alive(child)
        parent.kill()
        parent.wait()
        wait_until(lambda: not _alive(child), timeout=10, msg="the orphaned rank's exit")
    finally:
        if _alive(child):
            os.kill(child, signal.SIGKILL)


# -- a real CPU fleet of one worker over two gloo ranks -------------------------


def _launch_files(folder):
    out = {}
    for name in os.listdir(folder):
        if name.startswith("launches.") and name.endswith(".json"):
            with open(os.path.join(folder, name)) as f:
                r = json.load(f)
            out[r["pid"]] = r
    return out


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """TINY_GRU weights (drawn by torch, carried to the reference's layout),
    two requests and their replies from the port's staged stitch, a
    one-rank worker's session and ``roko_tpu``'s server, held equal."""
    import jax
    import torch

    from roko_tpu.config import MeshConfig as JMesh
    from roko_tpu.config import RokoConfig as JRoko
    from roko_tpu.config import ServeConfig as JServe
    from roko_tpu.parallel.mesh import make_mesh
    from roko_tpu.serve import server as ref_server
    from roko_tpu.serve.session import PolishSession as RefSession
    from roko_tpu_torch.infer import run_inference
    from roko_tpu_torch.models.convert import jax_from_state_dict
    from roko_tpu_torch.models.model import RokoModel
    from roko_tpu_torch.serve import server as port_server
    from roko_tpu_torch.serve.session import PolishSession
    from tests.test_lingru import TINY_GRU

    widths = {f: getattr(TINY_GRU, f) for f in ("embed_dim", "read_mlp", "hidden_size",
                                                 "num_layers")}
    model_cfg = ModelConfig(**widths)
    model = RokoModel(model_cfg, torch.Generator().manual_seed(6))
    pth = str(tmp_path_factory.mktemp("tiny") / "m.pth")
    torch.save(model.state_dict(), pth)
    rng = np.random.default_rng(8)
    requests = []
    for n in (7, 21):
        x = rng.integers(0, 12, (n, 200, 90)).astype(np.uint8)
        positions = np.zeros((n, 90, 2), np.int64)
        for i in range(n):
            positions[i, :, 0] = np.arange(i * 30, i * 30 + 90)
        requests.append(("".join(rng.choice(list("ACGT"), (n - 1) * 30 + 100)), positions, x))
    staged = [run_inference(iter([(["c"] * len(x), pos, x)]), {"c": d}, model, device="cpu",
                            log=lambda m: None)["c"] for d, pos, x in requests]

    def replies(srv):
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            return polish_all(f"http://127.0.0.1:{srv.server_address[1]}", requests)
        finally:
            srv.shutdown()
            srv.batcher.stop()
            srv.server_close()
            thread.join(5.0)

    cfg = RokoConfig(model=model_cfg, serve=ServeConfig(ladder=(8,)))
    one_rank = replies(port_server.make_server(
        PolishSession(model, cfg, device="cpu"), cfg.serve, port=0))
    jcfg = JRoko(model=TINY_GRU, mesh=JMesh(dp=1), serve=JServe(ladder=(8,)))
    ref_sess = RefSession(jax_from_state_dict(model.state_dict()), jcfg,
                          mesh=make_mesh(jcfg.mesh, jax.devices()[:1]))
    ref_sess.warmup()
    reference = replies(ref_server.make_server(ref_sess, jcfg.serve, port=0))
    assert one_rank == staged == reference
    return {"cfg": cfg, "pth": pth, "requests": requests, "want": staged}


def polish_all(base, requests):
    client = PolishClient(base, timeout=60.0)
    return [client.polish(d, pos, x, contig="c")["polished"] for d, pos, x in requests]


def _ranks_env(monkeypatch, tmp_path):
    """What the worker ranks inherit: their launch files under tmp_path,
    one thread, no stray ``ROKO_*`` of this process."""
    for k in list(os.environ):
        if k.startswith("ROKO_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("ROKO_KERNEL_LAUNCHES", str(tmp_path / "launches"))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _ranks(tmp_path, seen=()):
    """{rank: pid} of the ranks whose launch files are in tmp_path and
    not in ``seen``."""
    return {r["rank"]: pid for pid, r in _launch_files(tmp_path).items() if pid not in seen}


def test_real_worker_over_two_ranks_equals_one_rank_and_reference(tiny, tmp_path,
                                                                 monkeypatch):
    """One worker of ``devices_per_worker=2`` on the CPU: 2 gloo ranks
    whose replies equal a one-rank worker's, the staged stitch and the
    reference's; the drain leaves no rank, and the two exit files count
    the same dispatches (the follower's restart: the ``slow`` CLI test
    below, and the stub tests above)."""
    import dataclasses

    from roko_tpu_torch.serve.supervisor import boot_fleet, make_front_server

    _ranks_env(monkeypatch, tmp_path)
    cfg = dataclasses.replace(tiny["cfg"], fleet=fast_fleet_cfg(
        1, devices_per_worker=2, heartbeat_interval_s=0.1, spawn_deadline_s=120.0,
        runtime_dir=str(tmp_path / "rt")))
    fleet = boot_fleet(tiny["pth"], cfg, log=lambda m: None, device="cpu")[0]
    assert fleet.launch_spec().meta["ranks"] == 2
    fleet.start()
    server = make_front_server(fleet, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    w = fleet.workers[0]
    try:
        wait_until(lambda: w.state == READY, timeout=120.0, msg="worker ready")
        assert len(w.procs) == 2 and fleet.summary()["workers"]["0"]["ranks"] == 2
        pids = [p.pid for p in w.procs]
        assert polish_all(f"http://127.0.0.1:{server.server_address[1]}",
                          tiny["requests"]) == tiny["want"]
        log = (tmp_path / "rt" / "worker-0.log").read_text()
        assert "rank 1 of 2 (dp=2 tp=1 sp=1)" in log and "mesh dp=2 over 2 device(s)" in log
    finally:
        server.shutdown()
        server.server_close()
        thread.join(5.0)
        fleet.stop()
    assert [p.returncode for p in w.procs] == [0, 0] and w.restarts == 0
    assert not any(_alive(pid) for pid in pids)
    ranks = _ranks(tmp_path)
    assert sorted(ranks) == [0, 1] and sorted(ranks.values()) == sorted(pids)
    files = _launch_files(tmp_path)
    assert files[ranks[0]]["dispatches"] == files[ranks[1]]["dispatches"] > 0


@pytest.mark.slow
def test_serve_workers_cli_over_two_ranks_restarts_whole_and_drains_clean(tiny, tmp_path):
    """``serve --workers 1 --dp 2 --device cpu`` as a process (shared
    cards, the grid's 2 ranks, as on one card): ready with 2 ranks, the
    staged stitch's replies, a follower's SIGKILL restarts the worker
    once, and SIGTERM drains to exit 0 with no rank left."""
    import dataclasses

    rt = tmp_path / "rt"
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(dataclasses.replace(tiny["cfg"], fleet=fast_fleet_cfg(
        1, heartbeat_interval_s=0.2, spawn_deadline_s=120.0, stable_after_s=30.0,
        runtime_dir=str(rt))).to_json())
    announce = str(tmp_path / "front.json")
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and not k.startswith("ROKO_")}
    env.update(ROKO_COMPILE_CACHE="off", OMP_NUM_THREADS="1",
               ROKO_KERNEL_LAUNCHES=str(tmp_path / "launches"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "roko_tpu_torch", "serve", tiny["pth"], "--config",
         str(cfg_path), "--workers", "1", "--dp", "2", "--device", "cpu",
         "--port", "0", "--announce", announce],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    seen = set()
    try:
        wait_until(lambda: os.path.exists(announce) or proc.poll() is not None,
                   timeout=60.0, msg="front announce")
        assert proc.poll() is None, proc.stdout.read()
        port = json.load(open(announce))["port"]

        def worker0():
            return get_json(port, "/healthz")[1].get("workers", {}).get("0", {})

        wait_until(lambda: worker0().get("state") == READY, timeout=120.0, msg="worker ready")
        assert worker0()["ranks"] == 2
        base = f"http://127.0.0.1:{port}"
        assert polish_all(base, tiny["requests"]) == tiny["want"]
        wait_until(lambda: len(_ranks(tmp_path)) == 2, timeout=30.0, msg="both ranks' files")
        first = _ranks(tmp_path)
        seen.update(first.values())
        os.kill(first[1], signal.SIGKILL)
        wait_until(lambda: worker0().get("restarts") == 1 and worker0().get("state") == READY,
                   timeout=120.0, msg="the worker restarted")
        assert polish_all(base, tiny["requests"]) == tiny["want"]
        wait_until(lambda: len(_ranks(tmp_path, seen)) == 2, timeout=30.0,
                   msg="the new ranks' files")
        seen.update(_ranks(tmp_path, seen).values())
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60.0) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    assert len(seen) == 4
    wait_until(lambda: not any(_alive(pid) for pid in seen), timeout=10.0,
               msg="no rank after the drain")
