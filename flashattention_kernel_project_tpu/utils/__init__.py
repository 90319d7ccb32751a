from flashattention_kernel_project_tpu.utils.platform import (  # noqa: F401
    enable_compile_cache,
    hbm_bandwidth,
    peak_flops,
    peaks,
)
from flashattention_kernel_project_tpu.utils.benchmarking import (  # noqa: F401
    BenchResult,
    benchmark,
)
from flashattention_kernel_project_tpu.utils import oracles  # noqa: F401
from flashattention_kernel_project_tpu.utils.testing import (  # noqa: F401
    max_abs_diff,
    rel_l2,
    assert_max_abs,
    assert_rel_l2,
)
from flashattention_kernel_project_tpu.utils import health  # noqa: F401,E402
