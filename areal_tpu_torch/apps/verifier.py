"""The reward verification service's command line (port of
areal_tpu/apps/verifier.py):

    python -m areal_tpu_torch.apps.verifier --port 8090
    python -m areal_tpu_torch.apps.verifier --experiment e --trial t --port 8201 [--ttl 10]

Without ``--experiment`` it serves ``GET /health`` and ``POST /verify``
(`interfaces/reward_service`) until interrupted.  With ``--experiment``
and ``--trial`` it runs one member of the trial's verifier fleet
(`system/verifier_pool.VerifierWorker`): announced under
``names.verifier_servers`` with a keepalive TTL (a crashed worker
expires out of the pool without deregistering) and under the metrics
subtree.  An ``AREAL_FAULTS`` kill (``kill@t=2s``) crashes it as a
preempted node crashes, after a flight dump.

Code grading runs the submitted programs: the default bind is loopback,
and a non-loopback bind should set a shared token (--token or
AREAL_REWARD_TOKEN; clients send X-Areal-Token).
"""

import argparse
import logging
import os
import time

from areal_tpu_torch.interfaces import reward_service


def main(argv=None, serve=reward_service.serve):
    p = argparse.ArgumentParser(prog="areal_tpu_torch.apps.verifier",
                                description="reward verification server, alone or as one "
                                            "member of a trial's verifier fleet")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address; non-loopback binds should set --token")
    p.add_argument("--port", type=int, default=None,
                   help="0 picks an ephemeral port (default 8090 alone, 0 in a fleet)")
    p.add_argument("--token", default="", help="shared secret (or AREAL_REWARD_TOKEN)")
    p.add_argument("--max-workers", type=int, default=8, help="grading threads a batch")
    p.add_argument("--experiment", default="", help="join this experiment's verifier fleet")
    p.add_argument("--trial", default="", help="the fleet's trial")
    p.add_argument("--server-id", default="",
                   help="fleet identity (default: port-stable v<port>)")
    p.add_argument("--ttl", type=float, default=10.0,
                   help="keepalive TTL of the fleet announcement, seconds")
    args = p.parse_args(argv)
    token = args.token or os.environ.get("AREAL_REWARD_TOKEN", "")
    if not args.experiment:
        if args.trial or args.server_id:
            p.error("--trial and --server-id need --experiment (a fleet to join)")
        port = 8090 if args.port is None else args.port
        srv = serve(args.host, port, token=token, max_workers=args.max_workers)
        from areal_tpu_torch.base import tracer

        if tracer.enabled():  # the service stopped (an interrupt): its last events
            tracer.flush()
            logging.getLogger("areal_tpu_torch.verifier_app").info(
                f"tracer: {tracer.flush_stats()}")
        return srv
    if not args.trial:
        p.error("--experiment needs --trial")
    from areal_tpu_torch.system.verifier_pool import VerifierWorker

    worker = VerifierWorker(args.host, args.port or 0, token=token,
                            max_workers=args.max_workers)
    sid = worker.announce(args.experiment, args.trial, args.server_id or None, ttl=args.ttl)
    worker.announce_metrics(args.experiment, args.trial, sid)
    logging.getLogger("areal_tpu_torch.verifier_app").info(
        f"verifier {sid} serving at {worker.url}")
    try:
        while not worker._stop.is_set():
            time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    worker.close()
    return worker


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
