from nirgan_tpu_torch.tasks.px2px import Px2PxTask

__all__ = ["Px2PxTask"]
