"""TinyLlama-1.1B served through the DTensor-propagated steps on a (1, N) mesh,
one process per card, against the plain session on one card.

Each rank serves B 4 x 4,096 prompt, 32 tokens at full width (smoke size, B 4 x
64, 4 tokens, on the CPU) through ``serve_session(..., mesh=make_host_mesh(1,
N))``: its flash launches (each rank's heads), prefill seconds, decode ms a
step and peak memory, twice; rank 0 then counts one sharded prefill's
collectives (``CommDebugMode``) and holds the logits and tokens to the plain
session's on its card; then the same in f32 with TF32 off at 4 layers, B 4 x
512, 8 tokens (the sharded reductions' order apart from bf16 rounding).

    torchrun --nproc-per-node 4 scripts/sharded_serve_check.py cuda   # four cards
    PYTHONPATH=src torchrun --nproc-per-node 4 scripts/sharded_serve_check.py cpu
"""
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import serve_session
from repro_torch.models import api
from repro_torch.models.api import InputShape
dev = sys.argv[1]
full = dev == "cuda"
rank = int(os.environ["RANK"])
mesh = make_host_mesh(1, int(os.environ["WORLD_SIZE"]), dev)
d = torch.device(dev, int(os.environ["LOCAL_RANK"])) if full else torch.device("cpu")
cfg = get_config("tinyllama-1.1b", smoke=not full)
b, s, g = (4, 4096, 32) if full else (4, 64, 4)
gen = torch.Generator(device=d).manual_seed(0)
params = api.init(gen, cfg, d)
prompt = api.synth_batch(gen, cfg, InputShape("serve", s, b, "prefill"), d)
serve_session(cfg, b, 256 if full else 32, 2, device=d, params=params, verbose=False, mesh=mesh)
for rep in range(2):
    flash_attention_kernel.launches = 0
    res = serve_session(cfg, b, s, g, device=d, params=params, prompt=prompt, verbose=False,
                        mesh=mesh)
    print(f"[four] rank {rank} rep {rep}: flash launches {flash_attention_kernel.launches}, "
          f"prefill {res.prefill_seconds:.6f} s, decode {1e3 * res.decode_seconds / (g - 1):.3f} "
          f"ms a step, peak {torch.cuda.max_memory_allocated(d) / 2**30 if full else 0:.3f} GiB",
          flush=True)
with CommDebugMode() as comm:
    serve_session(cfg, b, s, 1, device=d, params=params, prompt=prompt, verbose=False, mesh=mesh)
if rank == 0:
    print(f"[four] collectives of one sharded prefill on rank 0: "
          f"{ {str(k): v for k, v in comm.get_comm_counts().items()} }", flush=True)
    plain = serve_session(cfg, b, s, g, device=d, params=params, prompt=prompt, verbose=False)
    diff = [float((x - y).abs().max()) for x, y in zip(res.logits, plain.logits)]
    same = (res.tokens == plain.tokens).float().mean().item()
    first = next((i for i in range(g) if not torch.equal(res.tokens[:, i], plain.tokens[:, i])), g)
    print(f"[four] vs the plain session on one card: prefill logits max |diff| {diff[0]:.4e}, "
          f"worst step {max(diff):.4e}; tokens equal {same:.4f} of them, first differing step "
          f"{first} of {g}; plain prefill {plain.prefill_seconds:.6f} s, decode "
          f"{1e3 * plain.decode_seconds / (g - 1):.3f} ms a step", flush=True)
# f32, TF32 off, 4 layers at full width, B 4 x 512, 8 tokens: rounding apart from bf16's
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cfg32 = cfg.with_(param_dtype="float32", activation_dtype="float32",
                  num_layers=4 if full else cfg.num_layers)
b32, s32, g32 = (4, 512, 8) if full else (2, 32, 4)
gen = torch.Generator(device=d).manual_seed(1)
p32 = api.init(gen, cfg32, d)
prompt32 = api.synth_batch(gen, cfg32, InputShape("f32", s32, b32, "prefill"), d)
res32 = serve_session(cfg32, b32, s32, g32, device=d, params=p32, prompt=prompt32,
                      verbose=False, mesh=mesh)
if rank == 0:
    plain32 = serve_session(cfg32, b32, s32, g32, device=d, params=p32, prompt=prompt32,
                            verbose=False)
    diff = max(float((x - y).abs().max()) for x, y in zip(res32.logits, plain32.logits))
    print(f"[four] f32 ({cfg32.num_layers} layers, B {b32} x {s32}, {g32} tokens): logits "
          f"max |diff| {diff:.4e} over every step, tokens equal "
          f"{bool(torch.equal(res32.tokens, plain32.tokens))}", flush=True)
torch.distributed.barrier()
print(f"[four] rank {rank} done", flush=True)
