"""The domain ETL in numpy and the standard library: raw Taobao theme-click
logs or Amazon category reviews -> the reference's on-disk domain layout,
byte-equal to the JAX package's ``mamdr_tpu/data/etl`` (which runs on pandas
and sklearn)."""

from mamdr_tpu_torch.data.etl.common import RawId2Id, split_domains

__all__ = ["RawId2Id", "split_domains"]
