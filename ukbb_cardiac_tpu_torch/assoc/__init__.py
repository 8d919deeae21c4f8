"""Statistics / association layer (PheWAS) — a copy of
``ukbb_cardiac_tpu/assoc`` (host numpy, scipy and pandas), with its own
copy of the field-catalogue tables under ``assoc/data/``."""

from ukbb_cardiac_tpu_torch.assoc.fdr import fdr_threshold, p_adjust_fdr
from ukbb_cardiac_tpu_torch.assoc.phewas import (
    age_by_date,
    build_confounders,
    clean_columns,
    deconfound_idps,
    load_continuous_map,
    load_field_categories,
    load_field_names,
    manhattan_plot,
    masked_pearson,
    normalise,
    normalise_non_idps,
    rank_normalise,
    significance_thresholds,
    top_hits_table,
    univariate_correlation,
)
