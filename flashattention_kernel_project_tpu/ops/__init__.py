"""Attention kernels for Hopper (Pallas through Triton), their plain
references, the online-softmax merge and the 8-bit quantizers."""

from flashattention_kernel_project_tpu.ops.softmax import (  # noqa: F401
    SoftmaxState,
    init_state,
    tile_state,
    merge,
    finalize,
    online_softmax_reference,
)
from flashattention_kernel_project_tpu.ops.flash_attention import (  # noqa: F401
    flash_attention,
    flash_attention_with_lse,
    flash_attention_ragged,
    flash_attention_kv_quant,
    flash_attention_kv_quant_with_lse,
    flash_attention_ragged_kv_quant,
    reference_attention,
    select_impl,
)
from flashattention_kernel_project_tpu.ops.flash_decode import (  # noqa: F401
    flash_decode,
    flash_decode_int8,
    flash_decode_fp8,
    fold_partials,
    merge_partials,
)
from flashattention_kernel_project_tpu.ops.quant import (  # noqa: F401
    quantize_int8,
    dequantize_int8,
    quantize_fp8,
    quantize_fp8_tokenwise,
    dequantize_fp8,
    quantize_kv,
    quantize_fp8_weights,
)
from flashattention_kernel_project_tpu.ops.paged_decode import (  # noqa: F401
    PagePool,
    gather_pages,
    paged_append,
    paged_append_chunk,
    paged_append_chunk_quant,
    paged_append_quant,
    paged_flash_decode,
    paged_flash_decode_quant,
    paged_flash_extend,
)
