from anystereo_tpu_torch.data.frame_utils import (  # noqa: F401
    read_gen,
    read_pfm,
    write_pfm,
    read_flo,
    write_flo,
    read_disp_kitti,
    read_disp_middlebury,
    read_disp_sintel,
    read_disp_tartanair,
)
from anystereo_tpu_torch.data.datasets import (  # noqa: F401
    StereoDataset,
    SceneFlowDataset,
    KittiDataset,
    KittiMixed,
    Middlebury,
    ETH3D,
    SintelStereo,
    FallingThings,
    TartanAir,
    fetch_dataset,
)
from anystereo_tpu_torch.data.loader import PrefetchLoader, collate_batch  # noqa: F401
