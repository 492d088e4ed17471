from anystereo_tpu_torch.ops.coords import (  # noqa: F401
    make_coord,
    make_coord_grid,
    to_pixel_samples,
)
from anystereo_tpu_torch.ops.sampling import (  # noqa: F401
    gather_1d_linear,
    nearest_sample,
    interp_bilinear,
    avg_pool2d,
)
from anystereo_tpu_torch.ops.cost_volume import (  # noqa: F401
    all_pairs_correlation,
    build_gwc_volume,
    build_concat_volume,
    build_correlation_volume,
    build_norm_correlation_volume,
    disparity_regression,
)
from anystereo_tpu_torch.ops.lookup import (  # noqa: F401
    CorrPyramid,
    build_pyramid,
    pyramid_lookup,
)
from anystereo_tpu_torch.ops.upsample import (  # noqa: F401
    context_upsample,
    context_upsample_queries,
    context_upsample_queries_quarter,
    unfold3x3,
)
