"""Parallelism: device meshes (sharded deploys and registration) and
subject fleets."""

from ukbb_cardiac_tpu_torch.parallel.cohort import (CohortResult,
                                                    process_subject_full,
                                                    process_subject_sa,
                                                    run_cohort_full,
                                                    run_cohort_sa)
from ukbb_cardiac_tpu_torch.parallel.fleet import (FleetResult, run_fleet,
                                                   shard_subjects)
from ukbb_cardiac_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    make_mesh,
    pad_batch_to_devices,
    replicated,
    shard_batch,
    spatial_sharding,
)
