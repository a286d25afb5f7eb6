from drt_tpu_torch.parallel.sharding import (  # noqa: F401
    RayMesh, make_ray_mesh, shard_views, replicate, make_sharded_train_step,
    pad_views_to_multiple,
)
