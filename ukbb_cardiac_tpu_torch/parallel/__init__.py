"""Subject fleets and the cohort driver (the JAX package's device meshes
are not ported)."""

from ukbb_cardiac_tpu_torch.parallel.cohort import (CohortResult,
                                                    process_subject_full,
                                                    process_subject_sa,
                                                    run_cohort_full,
                                                    run_cohort_sa)
from ukbb_cardiac_tpu_torch.parallel.fleet import (FleetResult, run_fleet,
                                                   shard_subjects)
