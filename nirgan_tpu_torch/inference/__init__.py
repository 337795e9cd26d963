from nirgan_tpu_torch.inference.histogram import histogram_match
from nirgan_tpu_torch.inference.synthesize import serve_batch, synthesize_dataset

__all__ = ["histogram_match", "serve_batch", "synthesize_dataset"]
