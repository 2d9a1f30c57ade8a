"""Hardware constants (TPU v5e target) used by the cost model and roofline.

These are the single source of truth — launch/roofline.py and core/costmodel
both import from here.  Documented assumptions (DESIGN.md §2):

* ICI: ~50 GB/s per link; we charge collectives at 50 GB/s per chip
  (conservative single-link effective bandwidth).
* DCN: 12.5 GB/s per host (100 Gbps NIC) — only traffic on the "pod" mesh
  axis pays this.
"""

PEAK_FLOPS_BF16 = 197e12  # per chip
HBM_BW = 819e9  # bytes/s per chip
ICI_BW = 50e9  # bytes/s per chip (effective, collectives)
DCN_BW_PER_HOST = 12.5e9  # bytes/s per host NIC

CHIPS_PER_HOST = 4
HBM_PER_CHIP = 16e9  # bytes
HOSTS_PER_POD = 64  # 16x16 = 256 chips / 4 chips-per-host

# XLA compile + first-dispatch overhead model for the "container creation"
# analogue (benchmarks/container_overhead.py fits these from measurement).
COMPILE_BASE_S = 20.0
COMPILE_PER_GPARAM_S = 3.0
