"""Serving A/B of two checkouts of the PyTorch/CUDA port on one GPU.

    python3 chip_serving_ab.py --tree DIR --label NAME [--plain-params]
        [--repeats 3]

Imports ``incubator_mxnet_tpu_torch`` from the checkout at ``DIR`` and
serves chip_smoke.py's engine workload with it: a 12-layer, 1024-wide,
16-head, V=32000 TransformerLM in bf16 from seed 0, one ServingEngine
(max_batch 8, block size 16, prefill chunk 32) over 8 requests of 32-300
prompt tokens, 32 new tokens each.  The workload is served ``--repeats``
times on fresh engines, then once more under ``torch.profiler``.
``--plain-params`` swaps every parameter of the model for a plain
``torch.nn.Parameter`` on the same storage before serving, to tell the
cost of the port's Parameter class apart from the rest of the code.

Prints one JSON line: per repeat the engine wall time, decoded tokens/s,
decode steps and prefill chunks, the mean host time of one
``PagedPrograms.step`` / ``prefill_chunk`` call (the call returns after
the card finishes, so it holds the device time too), and for the
profiled run the card's busy share and the kernels launched per
scheduler iteration.  Run it once per checkout, alternating, in one
call to the card: two checkouts compare only within one call.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--plain-params", action="store_true")
    ap.add_argument("--repeats", type=int, default=3)
    return ap.parse_args()


def main() -> int:
    args = _args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import incubator_mxnet_tpu_torch as port
    from incubator_mxnet_tpu_torch.models import TransformerLM
    from incubator_mxnet_tpu_torch.serving import ServingEngine
    from incubator_mxnet_tpu_torch.serving import programs as prog_mod

    assert os.path.dirname(os.path.dirname(port.__file__)) == tree, \
        port.__file__
    if not torch.cuda.is_available():
        print("chip_serving_ab: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    net = TransformerLM(vocab=32000, units=1024, hidden_size=4096,
                        num_layers=12, num_heads=16, max_len=512,
                        dropout=0.0, device="cuda", seed=0).cast("bfloat16")
    if args.plain_params:
        for mod in net.modules():
            for name, p in list(mod._parameters.items()):
                if p is not None:
                    mod._parameters[name] = torch.nn.Parameter(
                        p.data, requires_grad=False)
    kinds = sorted({type(p).__module__ + "." + type(p).__name__
                    for p in net.parameters()})

    calls = {"step": [], "prefill_chunk": []}
    for name in calls:
        real = getattr(prog_mod.PagedPrograms, name)

        def timed(self, *a, _real=real, _name=name, **k):
            t0 = time.perf_counter()
            out = _real(self, *a, **k)
            calls[_name].append(time.perf_counter() - t0)
            return out

        setattr(prog_mod.PagedPrograms, name, timed)

    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 32000, (n,)).astype(np.int32)
               for n in np.linspace(32, 300, 8).astype(int)]

    def serve():
        with ServingEngine(net, max_batch=8, block_size=16,
                           prefill_chunk=32) as eng:
            eng.submit(prompts[0][:40], 2).result(timeout=600)  # warm-up
            for v in calls.values():
                v.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reqs = [eng.submit(p, 32) for p in prompts]
            toks = [r.result(timeout=600) for r in reqs]
            wall = time.perf_counter() - t0
        n_steps, n_chunks = len(calls["step"]), len(calls["prefill_chunk"])
        return {"wall_s": wall,
                "tok_s": sum(len(t) for t in toks) / wall,
                "steps": n_steps, "chunks": n_chunks,
                "step_ms": 1e3 * sum(calls["step"]) / max(n_steps, 1),
                "chunk_ms": 1e3 * sum(calls["prefill_chunk"])
                / max(n_chunks, 1),
                "iteration_ms": 1e3 * wall / max(n_steps + n_chunks, 1)}, toks

    runs, first = [], None
    for _ in range(args.repeats):
        r, toks = serve()
        first = first or toks
        assert toks == first, "repeats disagree"
        runs.append(r)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        prof_run, _ = serve()
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    iters = prof_run["steps"] + prof_run["chunks"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()
    print(json.dumps({
        "label": args.label, "card": smi[0] if smi else None,
        "param_types": kinds, "runs": runs, "profiled": prof_run,
        "busy_share": busy_us * 1e-6 / prof_run["wall_s"],
        "kernels_per_iteration": len(kern) / max(iters, 1),
        "first_tokens": first[0][:4]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
