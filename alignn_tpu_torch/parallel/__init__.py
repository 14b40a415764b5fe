"""Data parallelism over ranks of ``torch.distributed`` (counterpart of
``alignn_tpu/parallel``): the process group and its mesh
(:mod:`~alignn_tpu_torch.parallel.mesh`) and the data-parallel train step
and trainer (:mod:`~alignn_tpu_torch.parallel.dp`)."""
