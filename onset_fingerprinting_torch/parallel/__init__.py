"""Multi-card processing on ``torch.distributed`` (port of
``onset_fingerprinting_tpu.parallel``): meshes of ranks, the process-group
set-up, and the sharded detector, fleet and serve paths."""

from onset_fingerprinting_torch.parallel.distributed import (
    global_mesh,
    init_distributed,
    pod_env_detected,
)
from onset_fingerprinting_torch.parallel.mesh import (
    Mesh,
    default_mesh,
    make_mesh,
)
from onset_fingerprinting_torch.parallel.sharding import (
    detect_events_time_sharded,
    detect_fingerprint_sharded,
    detect_offline_sharded,
    detect_offline_time_sharded,
    make_detect_fingerprint_sharded,
    make_detect_locate_sharded,
    shard_batch,
)
