"""Data and graph parallelism over ranks of ``torch.distributed``
(counterpart of ``alignn_tpu/parallel``): the process group, its mesh and
the differentiable collectives (:mod:`~alignn_tpu_torch.parallel.mesh`),
the data-parallel step and trainer (:mod:`~alignn_tpu_torch.parallel.dp`),
the edge-partitioned ring (:mod:`~alignn_tpu_torch.parallel.gp_batch`,
:mod:`~alignn_tpu_torch.parallel.gp_model`,
:mod:`~alignn_tpu_torch.parallel.graph_parallel`), the data x graph step
(:mod:`~alignn_tpu_torch.parallel.dp_gp`) and the dense layout's halo
exchange (:mod:`~alignn_tpu_torch.parallel.dense_gp`)."""
