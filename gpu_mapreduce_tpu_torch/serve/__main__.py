"""``python -m gpu_mapreduce_tpu_torch.serve`` — run the daemon standalone.

Prints one JSON line (``{"serving": <port>, ...}``) once the listener
is up, then blocks until ``POST /v1/shutdown`` (or ``python -m
gpu_mapreduce_tpu_torch.ctl shutdown``) stops it.  SIGTERM drains and
exits cleanly; ``kill -9`` is the case the journal exists for
(doc/serve.md#recovery).  It runs on the card; ``--device cpu`` is the
only way onto the host.  ``--fleet DIR --replica-id RID`` joins a
replica fleet (serve/fleet.py); ``--router --fleet DIR`` runs the fleet
router instead, which runs no job and never touches the card.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m gpu_mapreduce_tpu_torch.serve",
        description="MR-as-a-service daemon on the card (doc/serve.md)")
    p.add_argument("--port", type=int, default=None,
                   help="listen port (default MRTPU_SERVE_PORT or 0 "
                        "= ephemeral; the bound port lands in "
                        "<state>/serve.json)")
    p.add_argument("--workers", type=int, default=None,
                   help="worker pool size (default MRTPU_SERVE_WORKERS "
                        "or 2)")
    p.add_argument("--queue", type=int, default=None,
                   help="admission queue capacity (default "
                        "MRTPU_SERVE_QUEUE or 16)")
    p.add_argument("--state", default=None,
                   help="state directory: journal, sessions, results "
                        "(default MRTPU_SERVE_STATE or ./mrtpu-serve)")
    p.add_argument("--mesh", type=int, default=0,
                   help="build an N-shard mesh at start with the port's "
                        "make_mesh(N) (0 = one device)")
    p.add_argument("--device", choices=("cpu",), default=None,
                   help="run on the host (default: the card, and an "
                        "error without one)")
    p.add_argument("--paused", action="store_true",
                   help="admit + journal but do not execute "
                        "(maintenance staging)")
    p.add_argument("--fleet", default=None, metavar="DIR",
                   help="join the replica fleet rooted at DIR "
                        "(default MRTPU_FLEET_DIR; doc/serve.md)")
    p.add_argument("--replica-id", default=None, metavar="RID",
                   help="stable replica id within the fleet "
                        "(default MRTPU_FLEET_ID or r<pid>)")
    p.add_argument("--heartbeat", type=float, default=None,
                   metavar="SECS", help="fleet lease heartbeat "
                   "interval (default MRTPU_FLEET_HEARTBEAT)")
    p.add_argument("--lease", type=float, default=None, metavar="SECS",
                   help="fleet lease TTL (default MRTPU_FLEET_LEASE)")
    p.add_argument("--router", action="store_true",
                   help="run the fleet ROUTER instead of a replica "
                        "(requires --fleet; serve/router.py)")
    args = p.parse_args(argv)

    if args.router:
        if not args.fleet:
            p.error("--router requires --fleet DIR")
        from .router import Router
        rt = Router(args.fleet, port=args.port)
        port = rt.start()
        print(json.dumps({"serving": port, "router": True,
                          "fleet": args.fleet}), flush=True)
        stop = [False]

        def _term_r(signum, frame):
            stop[0] = True

        signal.signal(signal.SIGTERM, _term_r)
        try:
            import time as _time
            while not stop[0]:
                _time.sleep(0.5)
        except KeyboardInterrupt:
            pass
        rt.stop()
        return 0

    comm = None
    if args.mesh > 0:
        from ..parallel.mesh import make_mesh
        comm = make_mesh(args.mesh, devices=[args.device] * args.mesh
                         if args.device else None)

    from .daemon import Server
    srv = Server(port=args.port, workers=args.workers,
                 queue_cap=args.queue, state_dir=args.state,
                 comm=comm, paused=args.paused or None,
                 device=args.device, fleet_dir=args.fleet,
                 replica_id=args.replica_id, heartbeat_s=args.heartbeat,
                 lease_s=args.lease)
    port = srv.start()
    print(json.dumps({"serving": port, "state": srv.state_dir,
                      "workers": srv.nworkers, "paused": srv.paused,
                      "rid": srv.rid, "fleet": srv.fleet_dir,
                      "device": str(srv.device)}), flush=True)

    def _term(signum, frame):
        srv.shutdown()

    signal.signal(signal.SIGTERM, _term)
    try:
        while not srv.wait(timeout=1.0):
            pass
    except KeyboardInterrupt:
        srv.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
