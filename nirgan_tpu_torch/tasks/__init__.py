from nirgan_tpu_torch.tasks.baseline import BaselineTask
from nirgan_tpu_torch.tasks.px2px import Px2PxTask

__all__ = ["BaselineTask", "Px2PxTask"]
