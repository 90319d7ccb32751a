"""flashattention_kernel_project_tpu — a quantized attention engine in JAX.

Built on the capabilities of the CUDA kernel-study reference
`jeehun98/FlashAttention_Kernel_Project`: online/streaming softmax ->
fused FlashAttention forward and backward -> split-KV flash decode ->
8-bit (int8/fp8) weight and KV-cache paths -> multi-device sharded
attention (head/TP sharding, ring/context-parallel attention, distributed
decode).

Layout (mirrors SURVEY.md section 7 build plan):
  ops/       attention kernels (Pallas through Triton) and their references
  models/    flagship GQA transformer + decode engine built on ops/
  parallel/  mesh, shard_map wrappers, ring attention, distributed decode
  utils/     bench harness, CPU oracles, error metrics (the reference's
             per-file main()/verify scaffolding as a library — L3/L4/L5)
"""

__version__ = "0.1.0"

from flashattention_kernel_project_tpu import ops, utils  # noqa: F401
