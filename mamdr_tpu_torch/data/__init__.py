from mamdr_tpu_torch.data.dataset import DomainSplit, MultiDomainDataset
from mamdr_tpu_torch.data.synthetic import make_synthetic_dataset

__all__ = ["DomainSplit", "MultiDomainDataset", "make_synthetic_dataset"]
