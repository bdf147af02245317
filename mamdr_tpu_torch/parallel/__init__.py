"""The (data, table) mesh: one process a rank, explicit collectives
(``mesh``), row-sharded lookups through kernel K2 (``embedding_shard``),
each data rank's rows (``data_feed``), the train step and state on the mesh
(``trainer_sharding``), a standalone sharded trainer (``sharded_train``)
and the multi-rank dry run (``dryrun``). Counterpart of
``mamdr_tpu/parallel``."""

from mamdr_tpu_torch.parallel.mesh import init_distributed, make_mesh

__all__ = ["init_distributed", "make_mesh"]
