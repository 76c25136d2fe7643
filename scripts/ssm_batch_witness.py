#!/usr/bin/env python3
"""Where a batched prefill of an SSM stack parts from the same prompts
prefilled one at a time, on one NVIDIA card.

    python3 scripts/ssm_batch_witness.py [--arch mamba2-130m] [--lanes 4]
        [--prompt-len 512]

Seeded weights (the seed of ``chip_smoke.py``'s ``families`` phase) at the
config's full width and depth in its dtype, ``--lanes`` prompts of one
length, through ``models.api``'s ``prefill``.  Prints:

- first-token logits, batched against batch-1 and against a batch of the
  same prompt in every lane, as max |diff| over max |logit|;
- per row, the first layer whose output differs bit for bit from the
  batch-1 run's (``None``: none does);
- per op of one batched prefill: its calls on more than one row, the calls
  whose rows differ from the op run on each row alone (the same inputs, bit
  for bit), the first such call and the largest scaled difference;
- the SSD scan of the first layer on the whole batch at once
  (``ssm._ssd_scan``, what ``ssd_chunked`` ran on a batch before it
  scanned each row alone) against each row alone, then each of its
  products and prefix sums: the same comparison, and the kernels the
  library ran at batch 1 and at ``--lanes``.

Exits non-zero without a card.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def scaled(got, want):
    """max |got - want| over max |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@contextlib.contextmanager
def patched(module, name, make):
    fn = getattr(module, name)
    setattr(module, name, make(fn))
    try:
        yield
    finally:
        setattr(module, name, fn)


def rowwise(rows_of, key, seen):
    """A wrapper maker: each call on more than one row is replayed on every
    row alone and the outputs compared.  ``seen[key(args)]`` gathers
    [calls, calls whose rows differ, index of the first such call, max
    scaled difference]."""
    def make(fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            b = args[rows_of[0]].shape[0]
            if b == 1:
                return out
            rec = seen.setdefault(key(args), [0, 0, None, 0.0])
            worst = 0.0
            for r in range(b):
                one = fn(*[a[r:r + 1] if i in rows_of else a
                           for i, a in enumerate(args)], **kw)
                for o, w in zip(out if isinstance(out, tuple) else (out,),
                                one if isinstance(one, tuple) else (one,)):
                    if not torch.equal(o[r:r + 1], w):
                        worst = max(worst, scaled(o[r:r + 1], w))
            if worst > 0:
                rec[1] += 1
                if rec[2] is None:
                    rec[2] = rec[0]
            rec[0] += 1
            rec[3] = max(rec[3], worst)
            return out
        return wrapped
    return make


def kernels(fn):
    """The device kernels ``fn()`` runs, by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ssm_batch_witness: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    from repro_torch.configs import get_config
    from repro_torch.launch.serving import synthetic_trace
    from repro_torch.models import hybrid, layers, ssm
    from repro_torch.models.api import get_api

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cfg = get_config(args.arch)
    if cfg.family not in ("ssm", "hybrid"):
        raise SystemExit(f"{args.arch} is a {cfg.family} model, not an SSM "
                         f"stack")
    api = get_api(cfg)
    max_ctx = args.prompt_len + 17
    with torch.inference_mode():
        params = api.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                          "cuda")
    trace = synthetic_trace(args.lanes, vocab=cfg.vocab, seed=0,
                            rate_hz=0.0, prompt_lens=(args.prompt_len,),
                            max_news=(16,))
    toks = torch.as_tensor(np.stack([r.prompt for r in trace]),
                           dtype=torch.long, device="cuda")

    def prefill(tokens):
        with torch.inference_mode():
            logits, _ = api.prefill(params, cfg, {"tokens": tokens}, max_ctx)
        return logits[:, -1].float()

    batched = prefill(toks)
    solo = [scaled(batched[i], prefill(toks[i:i + 1])[0])
            for i in range(args.lanes)]
    same = [max(scaled(row, batched[i])
                for row in prefill(toks[i:i + 1].repeat(args.lanes, 1)))
            for i in range(args.lanes)]

    def layer_outputs(tokens):
        outs = []

        def make(step_of):
            def wrapped(c):
                step = step_of(c)

                def recorded(h, lp, lc):
                    h, nc = step(h, lp, lc)
                    outs.append(h.clone())
                    return h, nc
                return recorded
            return wrapped

        with patched(hybrid, "_ssm_step", make):
            prefill(tokens)
        return outs

    outs = layer_outputs(toks)
    split = []
    for i in range(args.lanes):
        alone = layer_outputs(toks[i:i + 1])
        split.append(next((n for n, (b, a) in enumerate(zip(outs, alone))
                           if not torch.equal(b[i:i + 1], a)), None))

    ops, scan_args = {}, []

    def capture(fn):
        def wrapped(*a, **kw):
            if not scan_args:
                scan_args.append((a, kw))
            return fn(*a, **kw)
        return wrapped

    wrap = [(ssm, "dot", (0,), lambda a: f"dot {tuple(a[1].shape)}"),
            (ssm, "_causal_conv", (2,), lambda a: "causal conv"),
            (ssm, "ssd_chunked", (0, 1, 2, 3), lambda a: "ssd_chunked"),
            (layers, "rmsnorm", (1,), lambda a: "rmsnorm"),
            (layers, "mlp_apply", (2,), lambda a: "shared MLP (B1)"),
            (layers, "logits", (2,), lambda a: "logits (f32)")]
    with contextlib.ExitStack() as stack:
        for module, name, rows_of, key in wrap:
            stack.enter_context(patched(module, name,
                                        rowwise(rows_of, key, ops)))
        stack.enter_context(patched(ssm, "ssd_chunked", capture))
        prefill(toks)

    # the first layer's scan on the whole batch at once, then its products
    # and prefix sums, each replayed on every row alone
    (x, A, B, C), kw = scan_args[0]
    parts, calls = {}, []

    def record(name, fn):
        def wrapped(*a, **k):
            calls.append((name, fn, a, k))
            return fn(*a, **k)
        return wrapped

    with torch.inference_mode():
        whole = ssm._ssd_scan(x, A, B, C, **kw)
        scan_rows = [scaled(whole[0][i:i + 1], ssm._ssd_scan(
            x[i:i + 1], A[i:i + 1], B[i:i + 1], C[i:i + 1], **kw)[0])
            for i in range(args.lanes)]
        with contextlib.ExitStack() as stack:
            for name in ("matmul", "cumsum"):
                stack.enter_context(patched(
                    torch, name, lambda fn, name=name: record(name, fn)))
            ssm._ssd_scan(x, A, B, C, **kw)
        for n, (name, fn, a, k) in enumerate(calls):
            rows_of = tuple(range(len(a)))
            key = (f"#{n} {name} "
                   f"{' x '.join(str(tuple(t.shape)) for t in a)}")
            rec = {}
            rowwise(rows_of, lambda _: "rows", rec)(fn)(*a, **k)
            parts[key] = dict(
                rows=rec["rows"],
                kernels_batch_1=kernels(lambda: fn(*[t[:1] for t in a], **k)),
                kernels_batch=kernels(lambda: fn(*a, **k)))

    print(f"[witness] {args.arch} ({cfg.family}) {cfg.n_layers} layers "
          f"d_model {cfg.d_model} {cfg.dtype}, {args.lanes} prompts of "
          f"{args.prompt_len}; on {smi}")
    print(f"[witness] first-token logits, batched vs batch-1 {solo}; vs a "
          f"batch of the same prompt {same}")
    print(f"[witness] first layer whose output differs from batch-1's, per "
          f"row: {split}")
    for k, v in ops.items():
        print(f"[witness] op {k}: calls {v[0]}, rows differ in {v[1]}, "
              f"first {v[2]}, max scaled {v[3]:.4g}")
    print(f"[witness] layer 0's scan on the batch at once vs each row "
          f"alone: {scan_rows}")
    for k, v in parts.items():
        r = v["rows"]
        print(f"[witness] scan's {k}: rows differ {r[1] > 0} (max "
              f"scaled {r[3]:.4g}); kernels at batch 1 "
              f"{[n[:72] for n in v['kernels_batch_1']]}, at batch "
              f"{args.lanes} {[n[:72] for n in v['kernels_batch']]}")
    print(json.dumps(dict(arch=args.arch, device=smi, batched_vs_solo=solo,
                          batched_vs_same_prompt=same, first_split=split,
                          ops=ops, scan_rows=scan_rows, scan_parts=parts)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
