"""Weak-scaling measurement on the virtual CPU mesh: fixed per-device
batch, devices ∈ {1, 2, 4, 8}, steady-state timing (compile + warmup
discarded).

The dev host has very few physical cores (`nproc` is printed into the
log); virtual CPU devices beyond the physical core count time-slice, so
the expected curve is ~flat per-batch time while devices <= cores, then
proportional slowdown — the measurement separates sharded-dispatch
overhead (visible at devices <= cores) from plain CPU oversubscription
(devices > cores). The analog on real hardware is one chip per device
over ICI, where per-device compute is truly parallel.

Usage: python benches/scaling.py [per_device_blocks] [block_size]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bench import make_corpus  # noqa: E402
from gzp_tpu.ops.deflate_kernel import DeflateEncodeConfig, encode_deflate_blocks  # noqa: E402

PB = int(sys.argv[1]) if len(sys.argv) > 1 else 2  # blocks per device
BS = int(sys.argv[2]) if len(sys.argv) > 2 else 32768
LEVEL = 3
REPS = 6


def main():
    print(f"host cores: {os.cpu_count()}  per-device batch: {PB}x{BS}  level {LEVEL}")
    cfg = DeflateEncodeConfig.for_level(BS, "mgzip", "none", LEVEL)
    devs = jax.devices()
    base_time = None
    rows = []
    for nd in (1, 2, 4, 8):
        b = nd * PB
        mesh = jax.sharding.Mesh(np.array(devs[:nd]), ("blocks",))
        sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("blocks"))
        rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
        data = np.frombuffer(make_corpus(b * BS), np.uint8).reshape(b, BS)
        dd = jax.device_put(data, sh)
        dl = jax.device_put(np.full((b,), BS, np.int32), sh)
        df = jax.device_put(np.zeros((b,), bool), sh)

        @jax.jit
        def enc(d, ln, fi):
            r = encode_deflate_blocks(cfg, d, ln, fi)
            return r["out_len"], r["check"]

        jax.block_until_ready(enc(dd, dl, df))  # compile + warmup
        jax.block_until_ready(enc(dd, dl, df))
        best = float("inf")
        for _ in range(REPS):
            t0 = time.perf_counter()
            jax.block_until_ready(enc(dd, dl, df))
            best = min(best, time.perf_counter() - t0)
        gbps = b * BS / best / 1e9
        if base_time is None:
            base_time = best
        eff = base_time / best  # weak scaling: ideal = flat per-batch time
        rows.append((nd, b, best * 1e3, gbps, eff))
        print(
            f"devices {nd}  batch {b:3d}x{BS}  per-batch {best * 1e3:8.2f} ms"
            f"  {gbps:7.4f} GB/s  weak-eff {eff * 100:6.1f}%",
            flush=True,
        )

    cores = os.cpu_count() or 1
    within = [r for r in rows if r[0] <= cores]
    if len(within) >= 2:
        print(
            f"weak-scaling efficiency at {within[-1][0]} devices (<= {cores} cores): "
            f"{within[-1][4] * 100:.1f}%"
        )

    # control: XLA:CPU already multithreads ONE device across all cores,
    # so raw weak scaling conflates sharding overhead with core
    # oversubscription. The meaningful number for the accelerator analogy
    # (one card per device, truly parallel) is sharded time vs SINGLE-device
    # time on the same total batch: their ratio isolates the cost the
    # sharded dispatch itself adds.
    print("\nsharding-overhead control (same total work, 1 device vs N):")
    for nd, b, sharded_ms, _, _ in rows[1:]:
        data = np.frombuffer(make_corpus(b * BS), np.uint8).reshape(b, BS)
        dd = jax.device_put(data, jax.sharding.SingleDeviceSharding(devs[0]))
        dl = jax.device_put(np.full((b,), BS, np.int32))
        df = jax.device_put(np.zeros((b,), bool))

        @jax.jit
        def enc1(d, ln, fi):
            r = encode_deflate_blocks(cfg, d, ln, fi)
            return r["out_len"], r["check"]

        jax.block_until_ready(enc1(dd, dl, df))
        jax.block_until_ready(enc1(dd, dl, df))
        best = float("inf")
        for _ in range(REPS):
            t0 = time.perf_counter()
            jax.block_until_ready(enc1(dd, dl, df))
            best = min(best, time.perf_counter() - t0)
        overhead = sharded_ms / (best * 1e3)
        print(
            f"batch {b:3d}x{BS}: 1-device {best * 1e3:8.2f} ms, {nd}-device "
            f"sharded {sharded_ms:8.2f} ms -> sharded/single = {overhead:5.2f}x"
            f"  (sharding efficiency {100 / overhead:5.1f}%)"
        )


if __name__ == "__main__":
    main()
