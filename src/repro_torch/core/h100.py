"""NVIDIA H100 SXM5 80 GB constants: the port's roofline, its dry run and
the kernels' bounds read them from here.

``core/hw.py`` stays the reference's TPU v5e constants: the copied cost
model and simulator model the reference's cluster.  Every figure below
is NVIDIA's public data sheet for the H100 SXM5 ("NVIDIA H100 Tensor
Core GPU" datasheet, SXM5 column; the sparsity figures halved to dense),
per GPU.
"""

# Tensor cores, dense (the data sheet's "with sparsity" figures halved)
BF16_FLOPS = 989e12  # BF16 / FP16 tensor core: 1,979 TFLOPS sparse
TF32_FLOPS = 494.7e12  # TF32 tensor core: 989 TFLOPS sparse
# f32 on the CUDA cores (FP32: 67 TFLOPS on the sheet; 66.9 at the boost
# clock, 132 SMs x 128 FMA/clk x 2 x 1.98 GHz)
F32_FLOPS = 66.9e12
# An f32-accurate product on the tensor cores as several TF32 products:
# three (big.big + big.small + small.big, "3xTF32") for f32 operands, two
# when one side is exact in TF32 (int8 or e4m3 values against f32)
TF32X3_FLOPS = TF32_FLOPS / 3
TF32X2_FLOPS = TF32_FLOPS / 2

HBM_BYTES_PER_S = 3.35e12  # HBM3
HBM_BYTES = 80e9

# NVLink 4: 900 GB/s total per GPU, 450 GB/s each way; 8 GPUs per HGX host
NVLINK_BYTES_PER_S = 450e9
GPUS_PER_HOST = 8
# between hosts: one 400 Gb/s NIC (ConnectX-7 / InfiniBand NDR) per GPU
NIC_BYTES_PER_S = 50e9

# the flop rate of each class of work the roofline and the kernels' bounds
# charge: a matmul's operand dtype on the tensor cores, f32 (and
# everything not a matmul) on the CUDA cores
RATES = {"bf16": BF16_FLOPS, "tf32": TF32_FLOPS, "tf32x3": TF32X3_FLOPS,
         "tf32x2": TF32X2_FLOPS, "f32": F32_FLOPS}
RATE_NAMES = {"bf16": "bf16 tensor cores, 989 TFLOP/s",
              "tf32": "TF32 tensor cores, 494.7 TFLOP/s",
              "tf32x3": "3xTF32 tensor cores, 164.9 TFLOP/s",
              "tf32x2": "2xTF32 tensor cores, 247.35 TFLOP/s",
              "f32": "f32 CUDA cores, 66.9 TFLOP/s"}
