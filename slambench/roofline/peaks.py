"""Published peaks of one NVIDIA H100 SXM5 (80 GB HBM3), at its full
power limit of 700 W.

  * HBM3 bandwidth 3.35 TB/s (NVIDIA H100 Tensor Core GPU data sheet).
  * 132 streaming multiprocessors at the 1,980 MHz maximum boost clock
    (the same data sheet's SXM5 boost clock; nvidia-smi's clocks.max.sm
    reads 1980 on the card).
  * 32-bit population count: 16 results per clock per SM for compute
    capability 9.0 (CUDA C++ Programming Guide, table "Throughput of
    Native Arithmetic Instructions", row "32-bit bit reverse / population
    count" for 9.0).
  * FP32 outside the tensor cores: 67 TFLOP/s (data sheet).
"""
HBM_BYTES_PER_S = 3.35e12
N_SM = 132
BOOST_HZ = 1.98e9
POPC_PER_CLK_SM = 16
POPC_PER_S = POPC_PER_CLK_SM * N_SM * BOOST_HZ
FP32_FLOPS = 67e12
