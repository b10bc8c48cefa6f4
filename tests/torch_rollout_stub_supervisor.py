"""Stub fleet supervisor driver for the port's rollout fault-injection
tests (``tests/test_torch_rollout.py``; a copy of
``tests/rollout_stub_supervisor.py`` on ``roko_tpu_torch``): the REAL Fleet + front end + RolloutController
+ journal recovery (``serve/rollout.py: recover_rollout``) over stdlib
stub workers (``torch_fleet_stub_worker.py``), so SIGKILL-the-supervisor
mid-rollout exercises the actual crash-consistency machinery in tier-1
— ~100 ms spawns, no torch import.

Versions are launch specs that set ``STUB_VERSION`` (and any
``--v2-env KEY=VAL`` extras for the target version), so healthz/replies
tell incarnations apart. The boot version is ``v1`` unless a journaled
half-done rollout says otherwise — exactly run_supervisor's recovery
decision, through the same ``recover_rollout``/``install_boot_spec``
path.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import threading

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

from roko_tpu_torch.config import FleetConfig, RokoConfig, ServeConfig  # noqa: E402
from roko_tpu_torch.serve.fleet import Fleet, WorkerLaunchSpec, write_announce  # noqa: E402
from roko_tpu_torch.serve.rollout import (  # noqa: E402
    RolloutController,
    RolloutJournal,
    recover_rollout,
)
from roko_tpu_torch.serve.httpbase import serve_forever  # noqa: E402
from roko_tpu_torch.serve.supervisor import make_front_server, rolling_drain  # noqa: E402

STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "torch_fleet_stub_worker.py")

log = functools.partial(print, flush=True)


def stub_spec(version: str, extra_env=None) -> WorkerLaunchSpec:
    env = {"STUB_VERSION": version}
    env.update(extra_env or {})
    return WorkerLaunchSpec(
        lambda wid, announce: [sys.executable, STUB, "--announce", announce],
        env=lambda wid: dict(env),
        version=version,
        meta={"model_path": f"ckpt-{version}",
              "bundle_dir": f"bundle-{version}"},
    )


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runtime-dir", required=True)
    ap.add_argument("--announce", required=True)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--bake-s", type=float, default=2.0)
    ap.add_argument(
        "--v2-env", action="append", default=[],
        help="KEY=VAL extras for the v2 launch spec (repeatable)",
    )
    args = ap.parse_args()
    v2_env = dict(kv.split("=", 1) for kv in args.v2_env)

    cfg = RokoConfig(
        serve=ServeConfig(max_queue=8, retry_after_s=0.2),
        fleet=FleetConfig(
            workers=args.workers,
            heartbeat_interval_s=0.1,
            heartbeat_timeout_s=2.0,
            restart_base_delay_s=0.05,
            restart_max_delay_s=0.2,
            storm_threshold=3,
            storm_reset_s=3600.0,
            stable_after_s=0.2,
            term_grace_s=2.0,
            bake_s=args.bake_s,
            rollout_ready_timeout_s=30.0,
            runtime_dir=args.runtime_dir,
        ),
    )
    fleet = Fleet(cfg, lambda *_: [], log=log)
    os.makedirs(fleet.runtime_dir, exist_ok=True)
    journal = RolloutJournal(
        os.path.join(fleet.runtime_dir, RolloutJournal.FILENAME)
    )
    boot = "v1"
    recovery = recover_rollout(journal, log)
    if recovery is not None:
        rec = recovery["record"]
        side = rec["to"] if recovery["action"] == "finalize" else rec["from"]
        boot = side.get("version") or "v1"
    fleet.install_boot_spec(
        stub_spec(boot, v2_env if boot == "v2" else None)
    )
    if boot != "v2":
        fleet.add_launch_spec(stub_spec("v2", v2_env))

    server = make_front_server(fleet, port=0)
    lock = threading.Lock()

    def start_rollout(payload):
        name = payload.get("name")
        with lock:
            if not isinstance(name, str) or not fleet.has_spec(name):
                return 400, {"error": f"unknown version {name!r}"}
            ctl = fleet.rollout
            if ctl is not None and ctl.active():
                return 409, {"error": "rollout in progress",
                             "status": ctl.status()}
            ctl = RolloutController(fleet, name, journal=journal, log=log)
            fleet.rollout = ctl
            ctl.start()
            return 202, ctl.status()

    server._start_rollout = start_rollout
    write_announce(args.announce, server.server_address[1])
    fleet.start()
    if recovery is not None:
        journal.delete()
    try:
        serve_forever(
            server,
            log=log,
            drain_fn=lambda: rolling_drain(server, fleet, log=log),
        )
    finally:
        fleet.stop(rolling=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
