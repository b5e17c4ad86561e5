"""Kernel-attribution tools: the port's counterparts of planet_tpu's Pallas
microbenchmarks in tools/ (its T rows). Each module splits one family of
the port's kernels into its parts on the card, variant by variant, with a
hand-written CUDA kernel (csrc/bench_*.cu) and a plain PyTorch version per
variant:

* noise_stages — the noise core of K1, K4 and K5 (splits, hashing, the
  rest) and K1's tile texel (blend, noise);
* lut — where a small lookup table should live (shared memory, registers
  and shuffles, __ldg, tensor cores) and what dependent, independent and
  chained lookups cost;
* span_parts — K2's per-record cost: setup, fragment math, atomics,
  records per warp, and the block-vectorized layout.

Run one on the card with `python -m planet_tpu_torch.tools.<name>`, or on
the CPU (plain versions only) with `--device cpu --small`. Beside them,
kernel_times times the main path's kernels (K1 at two occupancies, K2 on
the 1080p scene's records, K4, K5, t_noise) of this tree or of another
unpacked beside it, so two trees compare on one card in one run;
chip_smoke.py times the same calls (kernel_times.calls).
"""
