from dualforce_tpu_torch.parallel.mesh import create_mesh  # noqa: F401
from dualforce_tpu_torch.parallel.sharding import shard_params  # noqa: F401
