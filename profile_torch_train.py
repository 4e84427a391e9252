#!/usr/bin/env python3
"""Where the PyTorch port's LoRA training step spends its time, on one
NVIDIA GPU.

    python3 profile_torch_train.py [--seed N]

Builds chip_smoke.py's training job (llama3-8b at full width and depth,
f32 base from a seed, LoRA rank 16 on the attention projections, seq 2048,
global batch 8 in 4 microbatches, packed seeded documents through the byte
tokenizer) and runs its step function directly: two warm-up steps, two
untraced steps timed with the host clock around a synchronize, then one
step under torch.profiler with CPU and CUDA activity. It prints the
untraced step time, tokens/s and MFU (3 x forward FLOPs per token against
989 TFLOP/s bf16), the peak device memory, and for the traced step: the
device's busy time (CUDA activity: kernels, copies, memsets, on one
stream) and idle share of the step's wall time, the device time split
into K1 (flash forward), K2 (dq), K3 (dk/dv), GEMMs (cuBLAS and CUTLASS
kernels) and the rest, and the kernels by device time. The difference
between the traced and untraced step times is the profiler's overhead.
"""

import argparse
import json
import sys
import tempfile
import time

import chip_smoke

GROUPS = (("K1 flash_fwd", ("flash_fwd_kernel",)),
          ("K2 flash_bwd_dq", ("flash_bwd_dq_kernel",)),
          ("K3 flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
          ("GEMMs", ("gemm", "nvjet", "xmma", "cutlass", "cublas")))


def group_of(name):
    low = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "rest"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2
    from runbooks_tpu_torch.models.config import get_config
    from runbooks_tpu_torch.models.transformer import init_params
    from runbooks_tpu_torch.train import data
    from runbooks_tpu_torch.train.lora import (
        LoraConfig,
        create_lora_train_state,
        make_lora_train_step,
    )
    from runbooks_tpu_torch.train.optimizer import (
        OptimizerConfig,
        make_optimizer,
    )
    from runbooks_tpu_torch.utils import cuda_build
    from runbooks_tpu_torch.utils.hw import H100_PEAK_BF16_FLOPS

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {chip_smoke.card_line()} | torch {torch.__version__}",
          flush=True)
    cuda_build.build(chip_smoke.KERNELS)

    cfg = get_config("llama3-8b")
    seq, batch_size, k = chip_smoke.TRAIN_SEQ, 8, 4
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    base = init_params(cfg, gen, dev)
    lora_cfg = LoraConfig(rank=16, alpha=32.0)
    optimizer = make_optimizer(OptimizerConfig(learning_rate=2e-5))
    state = create_lora_train_state(lora_cfg, base, optimizer, gen)
    step_fn = make_lora_train_step(cfg, lora_cfg, optimizer,
                                   accumulate_steps=k)
    with tempfile.TemporaryDirectory(prefix="profile_train_") as workdir:
        path = f"{workdir}/docs.jsonl"
        chip_smoke.write_train_docs(path, args.seed)
        batches = data.dataset(path, seq, batch_size, epochs=None)

        def step(state):
            b = {key: torch.from_numpy(v).to(dev)
                 for key, v in next(batches).items()}
            state, metrics = step_fn(state, base, b)
            torch.cuda.synchronize()
            return state, float(metrics["loss"])

        for _ in range(2):
            state, _ = step(state)
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            state, loss = step(state)
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = step(state)
            traced_s = time.perf_counter() - t0

    step_s = sum(times) / len(times)
    tokens = batch_size * seq
    tps = tokens / step_s
    flops = 3.0 * cfg.flops_per_token(seq)
    print("untraced " + json.dumps({
        "step_s": times, "tokens_per_s": tps,
        "tflops_per_s": tps * flops / 1e12,
        "mfu": tps * flops / H100_PEAK_BF16_FLOPS, "loss": loss,
        "peak_memory_gb": peak / 1e9}), flush=True)

    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels)
    wall_us = traced_s * 1e6
    print(f"traced step {traced_s:.3f} s: device busy {busy_us / 1e3:.1f} "
          f"ms, busy share {busy_us / wall_us:.3f}, idle share "
          f"{1 - busy_us / wall_us:.3f}", flush=True)
    split = {}
    for e in kernels:
        g = split.setdefault(group_of(e.key), [0.0, 0])
        g[0] += e.self_device_time_total
        g[1] += e.count
    print("device time by group:", flush=True)
    for group, (us, n) in sorted(split.items(), key=lambda x: -x[1][0]):
        print(f"  {us / 1e3:9.1f} ms {100 * us / busy_us:5.1f}% launches "
              f"{n:6d}  {group}", flush=True)
    print("CUDA activity by device time:", flush=True)
    for e in kernels[:25]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms "
              f"{100 * e.self_device_time_total / busy_us:5.1f}% calls "
              f"{e.count:6d}  [{group_of(e.key)}] {e.key[:80]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
