"""Mesh-parallel rendering over ``torch.distributed`` (counterpart of
``pbrt_tpu/parallel``): one process per mesh device, the reference's
``jax.sharding.Mesh`` axes ``dp``, ``sp`` and ``tp`` as a
``DeviceMesh``, its ``psum`` / ``pmin`` / ``ppermute`` as process-group
collectives."""
