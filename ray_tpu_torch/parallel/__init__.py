"""The data-parallel learner's world, transport and gradient exchange
(counterpart of `ray_tpu/parallel/`): `distributed` starts and joins a
`torch.distributed` world, `mesh.LearnerGroup` is a rank's view of it,
`collectives` holds the fp32 and q8 exchanges (kernels K6a, K6b)."""
