from anystereo_tpu_torch.eval.metrics import (  # noqa: F401
    AverageMeterDict,
    compute_metrics,
    d1_metric,
    epe_metric,
    thres_metric,
)
from anystereo_tpu_torch.eval.occlusion import occ_mask, warp_disparity  # noqa: F401
from anystereo_tpu_torch.eval.padder import InputPadder  # noqa: F401
