"""Fleet supervisor entrypoint: SLO-driven autoscaling of gen servers
(port of areal_tpu/apps/fleet.py).

Runs :class:`areal_tpu_torch.system.fleet.FleetSupervisor` against a
trial's live metrics plane, spawning/draining LOCAL gen-server processes
via :class:`~areal_tpu_torch.system.fleet.LocalProcessFleet`::

    python -m areal_tpu_torch.apps.fleet \\
        --experiment exp0 --trial t0 \\
        --slo "crit: staleness_p99 <= 4" \\
        --spawn-cmd "python -m areal_tpu_torch.system.gen_server \\
                     --path /ckpt --port {port} \\
                     --experiment {experiment} --trial {trial}" \\
        --min-servers 1 --max-servers 4

A CRIT violation on a capacity signal (staleness_p99 / queue_depth /
backpressure) adds one server; a sustained idle window (goodput ~0,
fleet idle) drains one.  Membership epochs persist through the trial's
``RecoverInfo`` when ``--recover-root`` is given, so a restarted
supervisor resumes its epoch counter instead of re-counting from 0.

``--verifier-spawn-cmd`` adds a second, independently-scaled **verifier
lane** (:class:`~areal_tpu_torch.system.fleet.SupervisorLane` over
``python -m areal_tpu_torch.apps.verifier`` workers): grade-latency /
queue-depth CRITs (``--verifier-slo``, default scale-up signals
``grade_latency_p99`` and ``verifier_queue_depth``) spawn a grading
worker, an idle pool drains one, and a TTL-evicted crash is refilled
back to ``--verifier-min-servers`` without waiting out the cooldown.

One deliberate difference from the JAX entrypoint: the gen-server fleet
is built with ``sid_prefix="s"``, the id a generation server announces
(``s<port>``), so a drain deletes that server's key AND terminates the
process it names.  The JAX entrypoint keys its processes ``port<port>``,
so its drain deregisters the server but leaves the process serving, with
its weights in memory, until shutdown.
"""

import argparse
import logging
import shlex
import sys
from typing import List, Optional

from areal_tpu_torch.base import names
from areal_tpu_torch.system.fleet import (
    FleetSupervisor, LocalProcessFleet, SupervisorLane,
)

logger = logging.getLogger("areal_tpu_torch.fleet")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="areal_tpu_torch.apps.fleet")
    p.add_argument("--experiment", required=True)
    p.add_argument("--trial", default="trial")
    p.add_argument("--slo", action="append", default=[],
                   help="SLO rule (metrics_report grammar; the rule "
                        "states the invariant that must HOLD), e.g. "
                        "'crit: staleness_p99 <= 4'; repeatable")
    p.add_argument("--slo-file", default=None,
                   help="file of SLO rules, one per line (# comments)")
    p.add_argument("--spawn-cmd", default="",
                   help="gen-server launch command; {port}/{experiment}/"
                        "{trial} are substituted per spawn")
    p.add_argument("--base-port", type=int, default=8101)
    p.add_argument("--min-servers", type=int, default=1)
    p.add_argument("--max-servers", type=int, default=8)
    p.add_argument("--interval", type=float, default=2.0,
                   help="seconds between scrape/evaluate rounds")
    p.add_argument("--count", type=int, default=None,
                   help="rounds to run (default: forever)")
    p.add_argument("--action-cooldown", type=float, default=30.0,
                   help="minimum seconds between scale actions")
    p.add_argument("--idle-rounds", type=int, default=3,
                   help="consecutive idle scrapes before a drain")
    p.add_argument("--recover-root", default=None,
                   help="trial recover dir: persists membership epochs "
                        "through RecoverInfo.fleet_state")
    p.add_argument("--verifier-spawn-cmd", default="",
                   help="verifier-worker launch command "
                        "({port}/{experiment}/{trial} substituted); "
                        "enables the verifier lane")
    p.add_argument("--verifier-slo", action="append", default=[],
                   help="verifier-lane SLO rule, e.g. "
                        "'crit: grade_latency_p99 <= 5' or "
                        "'crit: verifier_queue_depth <= 64'; repeatable")
    p.add_argument("--verifier-base-port", type=int, default=8201)
    p.add_argument("--verifier-min-servers", type=int, default=1)
    p.add_argument("--verifier-max-servers", type=int, default=4)
    args = p.parse_args(argv)

    from areal_tpu_torch.apps.metrics_report import parse_slo_rule

    rule_texts = list(args.slo)
    if args.slo_file:
        with open(args.slo_file) as f:
            rule_texts += [
                ln.strip() for ln in f
                if ln.strip() and not ln.lstrip().startswith("#")
            ]
    rules = [parse_slo_rule(t) for t in rule_texts]

    procs = None
    spawn = drain = None
    if args.spawn_cmd:
        procs = LocalProcessFleet(
            shlex.split(args.spawn_cmd),
            experiment=args.experiment,
            trial=args.trial,
            base_port=args.base_port,
            sid_prefix="s",
        )
        spawn, drain = procs.spawn, procs.drain

    lanes = []
    verifier_procs = None
    if args.verifier_spawn_cmd:
        from areal_tpu_torch.system.verifier_pool import list_verifiers

        verifier_procs = LocalProcessFleet(
            shlex.split(args.verifier_spawn_cmd),
            experiment=args.experiment,
            trial=args.trial,
            base_port=args.verifier_base_port,
            name_key=names.verifier_server,
            sid_prefix="v",
        )
        lanes.append(
            SupervisorLane(
                name="verifier",
                list_servers=lambda: list_verifiers(
                    args.experiment, args.trial
                ),
                rules=[parse_slo_rule(t) for t in args.verifier_slo],
                spawn=verifier_procs.spawn,
                drain=verifier_procs.drain,
                min_servers=args.verifier_min_servers,
                max_servers=args.verifier_max_servers,
                action_cooldown_s=args.action_cooldown,
                idle_rounds=args.idle_rounds,
            )
        )

    sup = FleetSupervisor(
        experiment=args.experiment,
        trial=args.trial,
        rules=rules,
        spawn=spawn,
        drain=drain,
        min_servers=args.min_servers,
        max_servers=args.max_servers,
        action_cooldown_s=args.action_cooldown,
        idle_rounds=args.idle_rounds,
        recover_root=args.recover_root,
        lanes=lanes,
    )
    logger.info(
        f"fleet supervisor: {len(rules)} SLO rule(s), "
        f"servers in [{args.min_servers}, {args.max_servers}], "
        f"epoch {sup.membership_epoch}"
    )
    try:
        actions = sup.run(count=args.count, interval=args.interval)
    except KeyboardInterrupt:
        actions = []
    finally:
        if procs is not None:
            procs.shutdown()
        if verifier_procs is not None:
            verifier_procs.shutdown()
    for a in actions:
        logger.info(f"action taken: {a.action} {a.victim} ({a.reason})")
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    sys.exit(main())
