"""Which ``torch.distributed`` calls the gloo backend carries on CUDA
tensors.

The mesh tier's ranks that share one card join over gloo
(``launch.mesh``), whose transport may or may not take a CUDA tensor for a
given call; a call it cannot carry can raise or abort its process.  So
each call runs in a world of its own: two spawned ranks
(``launch.mesh.spawn_ranks``) that call it once on an 8-element CUDA
tensor and synchronize.  The script prints one line a call, ``ok`` with
the ranks' results or the first line of the error that ended the world,
and the card's name and power limit.

Run on a machine with a card from the repo's root:
``python3 scripts/gloo_cuda_probe.py``.
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

CALLS = ("all_reduce", "broadcast", "all_gather", "reduce_scatter_tensor",
         "all_gather_into_tensor", "all_to_all_single", "reduce",
         "batch_isend_irecv", "send_recv", "barrier")


def one_call(rank, call):
    """Rank body: ``call`` once on a CUDA tensor; returns its sum."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    x = torch.ones(8, device=dev)
    if call == "all_reduce":
        dist.all_reduce(x)
    elif call == "broadcast":
        dist.broadcast(x, 0)
    elif call == "all_gather":
        dist.all_gather([torch.empty_like(x) for _ in range(2)], x)
    elif call == "reduce_scatter_tensor":
        dist.reduce_scatter_tensor(torch.empty(4, device=dev), x)
    elif call == "all_gather_into_tensor":
        dist.all_gather_into_tensor(torch.empty(16, device=dev), x)
    elif call == "all_to_all_single":
        dist.all_to_all_single(torch.empty_like(x), x)
    elif call == "reduce":
        dist.reduce(x, 0)
    elif call == "batch_isend_irecv":
        r = torch.empty_like(x)
        for q in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, 1 - rank),
                dist.P2POp(dist.irecv, r, 1 - rank)]):
            q.wait()
        x = r
    elif call == "send_recv":
        if rank == 0:
            dist.send(x, 1)
        else:
            dist.recv(x, 0)
    elif call == "barrier":
        dist.barrier()
    torch.cuda.synchronize()
    return float(x.sum())


def main():
    import torch

    from repro_torch.launch.mesh import spawn_ranks

    if not torch.cuda.is_available():
        raise SystemExit("gloo_cuda_probe: needs a CUDA card")
    import gloo_cuda_probe as me  # the ranks import their body by name

    for call in CALLS:
        try:
            got = spawn_ranks(me.one_call, 2, (call,), timeout_s=60)
            verdict = f"ok {got}"
        except Exception as e:  # the world's end is the answer
            lines = [ln for ln in str(e).strip().splitlines() if ln.strip()]
            verdict = f"{type(e).__name__}: {lines[-1][:160] if lines else ''}"
        print(f"[gloo-cuda] {call}: {verdict}", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
