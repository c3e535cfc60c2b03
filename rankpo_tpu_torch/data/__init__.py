"""data layer of the PyTorch port (see the matching rankpo_tpu.data)."""

from rankpo_tpu_torch.data.datasets import (  # noqa: F401
    ContrastiveDataset,
    PairPreferenceDataset,
    StreamingContrastiveDataset,
)
