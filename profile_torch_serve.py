#!/usr/bin/env python3
"""Where the PyTorch port's serving time goes, on one NVIDIA GPU.

    python3 profile_torch_serve.py [--seed N]

Loads llama3-8b (bfloat16, seeded random weights) as chip_smoke.py does and
serves chip_smoke.py's 8-request mix three times on fresh engines: once to
warm up, once untraced (the end-to-end numbers), once under torch.profiler
with CPU and CUDA activity (the breakdown). It prints, for the traced run:
wall time, device busy time (the CUDA activity's time: kernels, copies,
memsets, one stream so no overlap) and its share of the wall, host time
and device busy time inside the prefill and decode dispatches, and the
CUDA kernels by device time. The difference between the traced and
untraced wall times is the profiler's overhead.
"""

import argparse
import json
import sys
import time

import chip_smoke


def serve_once(torch, cfg, params, seed):
    from runbooks_tpu_torch.ops.flash_attention import flash_attention
    from runbooks_tpu_torch.serve.engine import InferenceEngine

    engine = InferenceEngine(cfg, params, max_slots=8, max_seq_len=2048,
                             seed=seed)
    first_t = {}
    reqs = chip_smoke.smoke_requests(chip_smoke.smoke_prompts(seed), first_t)
    flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not all(r.finished and len(r.output_tokens) == chip_smoke.MAX_TOKENS
               for r in reqs):
        raise SystemExit("a request did not finish with its tokens")
    ttft = sorted(first_t[i] - t0 for i in range(len(reqs)))
    return {"wall_s": wall, "ttft_s_median": ttft[len(ttft) // 2],
            "ttft_s_max": ttft[-1], "decode_steps": engine.steps,
            "prefill_dispatches": engine.prefill_dispatches,
            "flash_fwd_launches": flash_attention.launches}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 2
    from runbooks_tpu_torch.serve.api import load_model

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {chip_smoke.card_line()} | torch {torch.__version__}",
          flush=True)
    cfg, params = load_model({"model": "llama3-8b",
                              "model_overrides": {"param_dtype": "bfloat16"},
                              "seed": args.seed})
    with torch.no_grad():
        serve_once(torch, cfg, params, args.seed)
        untraced = serve_once(torch, cfg, params, args.seed)
        print("untraced " + json.dumps(untraced), flush=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced = serve_once(torch, cfg, params, args.seed)
    print("traced " + json.dumps(traced), flush=True)

    from torch.autograd import DeviceType

    events = prof.key_averages()
    labels = ("prefill_dispatch", "decode_dispatch")
    # CUDA activity only (kernels, copies, memsets): CPU ops carry their
    # kernels' time too, and the labels' device-side ranges span gaps.
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and e.key not in labels
                      and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    device_us = sum(e.self_device_time_total for e in kernels)
    wall_us = traced["wall_s"] * 1e6
    print(f"device busy {device_us / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms "
          f"wall: busy share {device_us / wall_us:.3f}, idle share "
          f"{1 - device_us / wall_us:.3f}", flush=True)
    for e in events:
        if e.key in labels and e.device_type == DeviceType.CPU:
            print(f"{e.key}: calls {e.count} host {e.cpu_time_total / 1e3:.1f}"
                  f" ms, device busy inside {e.device_time_total / 1e3:.1f} "
                  f"ms", flush=True)
    print("CUDA activity by device time:", flush=True)
    for e in kernels[:20]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms "
              f"{100 * e.self_device_time_total / device_us:5.1f}% "
              f"calls {e.count:6d}  {e.key[:90]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
