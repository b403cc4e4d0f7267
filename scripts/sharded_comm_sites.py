"""Where the sharded prefill's collectives come from: one
``serve_session(..., mesh=...)`` prefill on fake tensors in a ``"fake"``
process group (no card, no data moved), each collective that one rank
issues listed by kind, the port's line that caused it, the explicit
``redistribute`` (with its source placements) or else the DTensor op
being propagated (with its inputs' placements), and the local shape.

    PYTHONPATH=src python scripts/sharded_comm_sites.py                  # TinyLlama full, (1, 4)
    PYTHONPATH=src python scripts/sharded_comm_sites.py --arch gemma-2b --mesh 1,8
    PYTHONPATH=src python scripts/sharded_comm_sites.py --smoke --batch 4 --seq 64

The totals are ``CommDebugMode``'s; the table's rows add up to them.
"""
import argparse
import collections
import inspect
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.launch import dryrun, sharding
from repro_torch.launch.hlo_analysis import _COLLECTIVE_NS
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import serve_session
from repro_torch.models import api
from repro_torch.models.api import InputShape


class CollectiveSites(TorchDispatchMode):
    """Counts each collective by (op, the innermost ``repro_torch`` frame,
    the DTensor op that issued it, the local input shape)."""

    def __init__(self):
        super().__init__()
        self.sites = collections.Counter()
        self._op = "-"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            pls = [tuple(str(p) for p in a.placements) for a in args if isinstance(a, DTensor)]
            self._op = f"{func} {pls}"
            return NotImplemented          # DTensor desugars it into local ops first
        name = func._overloadpacket.__name__
        if func.namespace in _COLLECTIVE_NS and not name.startswith("wait"):
            stack = inspect.stack()[1:]
            where = next((f"{os.path.basename(f.filename)}:{f.lineno} {f.function}"
                          for f in stack if f"{os.sep}repro_torch{os.sep}" in f.filename), "-")
            # an explicit DTensor.redistribute, else the op DTensor was propagating
            op = next((f"redistribute {[str(p) for p in f.frame.f_locals['self'].placements]}"
                       for f in stack if f.function == "redistribute"
                       and isinstance(f.frame.f_locals.get("self"), DTensor)), self._op)
            shape = tuple(args[0].shape) if isinstance(args[0], torch.Tensor) else None
            self.sites[(name, where, op, shape)] += 1
        return func(*args, **kwargs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--mesh", default="1,4", help="DATA,MODEL")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--smoke", action="store_true", help="the smoke config")
    args = ap.parse_args(argv)
    data, model = (int(x) for x in args.mesh.split(","))
    cfg = get_config(args.arch, smoke=args.smoke)
    sites = CollectiveSites()
    with dryrun.fake_world(data * model):
        mesh = make_host_mesh(data, model, "cpu")
        with FakeTensorMode():
            params = sharding.shard_params(dryrun.fake_params(cfg), mesh)
            prompt = api.synth_batch(torch.Generator().manual_seed(1), cfg,
                                     InputShape("p", args.seq, args.batch, "prefill"), "cpu")
            with CommDebugMode() as comm, sites:
                serve_session(cfg, args.batch, args.seq, 1, device="cpu", params=params,
                              prompt=prompt, verbose=False, mesh=mesh, impl="plain")
    print(f"{args.arch}{' (smoke)' if args.smoke else ''}: {cfg.num_layers} layers, "
          f"{cfg.num_heads} / {cfg.num_kv_heads} heads, B {args.batch} x {args.seq}, mesh "
          f"({data}, {model}), torch {torch.__version__}")
    print("one prefill on rank 0 (CommDebugMode):",
          {str(k): v for k, v in comm.get_comm_counts().items()})
    for (name, where, op, shape), n in sorted(sites.sites.items(),
                                              key=lambda kv: (kv[0][1], kv[0][0])):
        print(f"{n:5d}  {name:28s} {where:36s} {op}  local {shape}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
