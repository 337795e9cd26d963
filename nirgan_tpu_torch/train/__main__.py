"""``python -m nirgan_tpu_torch.train``: the training CLI
(``train/cli.py``)."""

from nirgan_tpu_torch.train.cli import main

if __name__ == "__main__":
    main()
