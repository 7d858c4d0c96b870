"""The hyperkube analog — cmd/hyperkube: every component behind one
entrypoint, dispatched by the first argument:

    python -m kubernetes_tpu_torch scheduler [--nodes N --pods P --config F]
                                             [--device D]
    python -m kubernetes_tpu_torch ktctl     [--server URL] VERB ...
    python -m kubernetes_tpu_torch ktadm     {init|reset|preflight} --workdir D
    python -m kubernetes_tpu_torch apiserver [--port P --nodes N]
    python -m kubernetes_tpu_torch version

The reference builds one fat binary whose argv[0]/first-arg selects the
component (cmd/hyperkube/hyperkube.go Server registry); here the module
main does the same over the in-process components.

PyTorch port of kubernetes_tpu/__main__.py. `scheduler` runs the port's
daemon (server/daemon.main), which schedules on the card unless
`--device cpu` names the CPU, and raises when there is no card. The usage
line names this package; everything else is the reference's.
"""

from __future__ import annotations

import sys


def _run_apiserver(argv) -> int:
    """Standalone apiserver: REST facade over an in-process store with an
    optional hollow-node preload, serving until interrupted."""
    import argparse
    import time

    from kubernetes_tpu_torch.api.types import make_node
    from kubernetes_tpu_torch.server.apiserver import ApiServer
    from kubernetes_tpu_torch.server.rest_http import RestServer

    ap = argparse.ArgumentParser(prog="kubernetes-tpu apiserver")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--nodes", type=int, default=0)
    ap.add_argument("--once", action="store_true",
                    help="print the address and exit (smoke mode)")
    args = ap.parse_args(argv)
    api = ApiServer()
    from kubernetes_tpu_torch.api.workloads import Namespace
    api.store.create("Namespace", Namespace("default"))
    for i in range(args.nodes):
        api.store.create("Node", make_node(f"node-{i:04d}"))
    srv = RestServer(api, port=args.port)
    srv.start()
    print(f"apiserver listening on http://127.0.0.1:{srv.port}")
    if args.once:
        srv.stop()
        return 0
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()
    return 0


def _run_ktadm(argv) -> int:
    import argparse

    from kubernetes_tpu_torch.cli.ktadm import KtAdm

    ap = argparse.ArgumentParser(prog="kubernetes-tpu ktadm")
    ap.add_argument("phase", choices=["init", "reset", "preflight"])
    ap.add_argument("--workdir", default="./ktadm-cluster")
    args = ap.parse_args(argv)
    adm = KtAdm()
    if args.phase == "init":
        adm.init(args.workdir)
    elif args.phase == "reset":
        adm.reset(args.workdir)
    else:
        return 1 if adm.preflight(args.workdir) else 0
    return 0


def _run_scheduler(argv) -> int:
    from kubernetes_tpu_torch.server.daemon import main as daemon_main
    daemon_main(argv)
    return 0


def _run_ktctl(argv) -> int:
    from kubernetes_tpu_torch.cli.ktctl import main as ktctl_main
    return ktctl_main(argv)


COMPONENTS = {
    "scheduler": _run_scheduler,
    "ktctl": _run_ktctl,
    "ktadm": _run_ktadm,
    "apiserver": _run_apiserver,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print("usage: python -m kubernetes_tpu_torch "
              f"{{{'|'.join(sorted(COMPONENTS))}|version}} ...")
        return 0
    comp, rest = argv[0], argv[1:]
    if comp == "version":
        from kubernetes_tpu_torch.server.rest_http import VERSION
        print(f"kubernetes-tpu {VERSION['gitVersion']} "
              f"(hyperkube-style dispatcher)")
        return 0
    fn = COMPONENTS.get(comp)
    if fn is None:
        print(f"error: unknown component {comp!r}; have "
              f"{sorted(COMPONENTS)} + version", file=sys.stderr)
        return 1
    return fn(rest)


if __name__ == "__main__":
    sys.exit(main())
