"""Multi-device rendering over torch.distributed, one process per device:
process groups and collectives (group), the dp x sp sharded path tracer
(mesh) and the ring photon map's eye pass (ppm_ring).

Port of pathtracer_tpu/parallel/. The JAX package runs one program over a
jax.sharding.Mesh (shard_map, psum, ppermute); here every device has its
own process, and the groups come from
torch.distributed.device_mesh.init_device_mesh."""
