"""The reward verification service's command line (port of
areal_tpu/apps/verifier.py, without the fleet announcement):

    python -m areal_tpu_torch.apps.verifier --port 8090

serves ``GET /health`` and ``POST /verify`` (`interfaces/reward_service`)
until interrupted.  Code grading runs the submitted programs: the
default bind is loopback, and a non-loopback bind should set a shared
token (--token or AREAL_REWARD_TOKEN; clients send X-Areal-Token).
Joining a trial's verifier fleet (``--experiment``, ``--trial``,
``--server-id``, ``--ttl``) is ROADMAP queue 1 item 7.5.
"""

import argparse
import logging
import os

from areal_tpu_torch.interfaces import reward_service


def main(argv=None, serve=reward_service.serve):
    p = argparse.ArgumentParser(prog="areal_tpu_torch.apps.verifier",
                                description="reward verification server")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address; non-loopback binds should set --token")
    p.add_argument("--port", type=int, default=8090, help="0 picks an ephemeral port")
    p.add_argument("--token", default="", help="shared secret (or AREAL_REWARD_TOKEN)")
    p.add_argument("--max-workers", type=int, default=8, help="grading threads a batch")
    for flag in ("--experiment", "--trial", "--server-id"):
        p.add_argument(flag, default="", help="not yet ported")
    p.add_argument("--ttl", type=float, default=None, help="not yet ported")
    args = p.parse_args(argv)
    if args.experiment or args.trial or args.server_id or args.ttl is not None:
        raise SystemExit("joining a verifier fleet (--experiment/--trial/--server-id/--ttl) "
                         "is not yet ported (ROADMAP queue 1, item 7.5: the fleet)")
    return serve(args.host, args.port, token=args.token or os.environ.get(
        "AREAL_REWARD_TOKEN", ""), max_workers=args.max_workers)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
