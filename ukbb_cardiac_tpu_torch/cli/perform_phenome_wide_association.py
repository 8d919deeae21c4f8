"""CLI twin of ``assoc/perform_phenome_wide_association.py`` — PheWAS.

A copy of ``ukbb_cardiac_tpu/cli/perform_phenome_wide_association.py``
over the port's ``assoc`` (host work: no card, so no ``--device``).  The
Manhattan plot needs matplotlib (imported when the plot is drawn).

Usage:
  python -m ukbb_cardiac_tpu_torch.cli.perform_phenome_wide_association \
      --idp_csv <IDPs.csv> --pheno_csv <category CSVs> --output_dir <dir>

Inputs are paths (the reference hard-codes them,
``perform_phenome_wide_association.py:37,42``): the IDP table, the
per-category non-imaging CSVs, the field-metadata TSV and the
continuous-field map.  Outputs the same artefact set: confounders.csv,
normalised tables, correlation/p tables, a Manhattan plot and top-hit
tables.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import pandas as pd

from ukbb_cardiac_tpu_torch.assoc import (
    build_confounders,
    clean_columns,
    deconfound_idps,
    load_continuous_map,
    load_field_categories,
    load_field_names,
    manhattan_plot,
    normalise_non_idps,
    significance_thresholds,
    top_hits_table,
    univariate_correlation,
)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--idp_csv", required=True,
                        help="Imaging phenotypes (clinical_measures.csv).")
    parser.add_argument("--pheno_csv", nargs="+", required=True,
                        help="Per-category non-imaging CSVs (two-row header).")
    parser.add_argument("--field_tsv", default=None,
                        help="TSV: category id, field id, category, "
                             "description (ukb_field_added.txt format). "
                             "Defaults to the shipped copy under "
                             "assoc/data/.")
    parser.add_argument("--category_tsv", default=None,
                        help="TSV: category id, field id, category name — "
                             "the recommended-category tables. Defaults to "
                             "the shipped assoc/data/ukb_field_categories.tsv.")
    parser.add_argument("--continuous_csv", default=None,
                        help="Field-ID → is-continuous map. Defaults to "
                             "the shipped assoc/data/continuous.csv.")
    parser.add_argument("--output_dir", required=True)
    args = parser.parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)

    def out(name):
        return os.path.join(args.output_dir, name)

    # Steps 1-2: load tables (perform_phenome_wide_association.py:64-98)
    df_idp = pd.read_csv(args.idp_csv, index_col=0)
    df = pd.concat([pd.read_csv(p, header=[0, 1], index_col=0)
                    for p in args.pheno_csv], axis=1)
    df = df.loc[df_idp.index]

    field_names = load_field_names(args.field_tsv)
    ukb_cat, ukb_catname = load_field_categories(
        args.category_tsv or args.field_tsv)
    d_cat = {fid: cid for cid, fids in ukb_cat.items() for fid in fids}

    # Step 3: confounders (:119-147)
    conf, valid = build_confounders(df)
    df = df[valid]
    df_idp = df_idp[valid]
    conf = conf[valid]
    pd.DataFrame(conf, index=df.index,
                 columns=["Sex", "Age", "Sex * Age", "Weight", "Height"]
                 ).to_csv(out("confounders.csv"))
    drop = [c for c in df.columns if c[1].split("-")[0] in
            ("31", "34", "52", "53", "21003", "21002", "21001")]
    df = df.drop(columns=drop)

    # Step 4: clean + normalise (:172-269)
    df = clean_columns(df)
    df_cont = load_continuous_map(args.continuous_csv)
    df = normalise_non_idps(df, df_cont)
    df.to_csv(out("normalised_non_IDPs.csv"))
    df_idp, beta = deconfound_idps(df_idp, conf)
    df_idp.to_csv(out("normalised_IDPs.csv"))
    pd.DataFrame(beta, index=["sex", "age", "sex * age", "weight", "height"],
                 columns=df_idp.columns).to_csv(out("beta_IDPs.csv"))

    # Step 5: univariate correlations (:274-325)
    df_corr, df_p, df_log_p = univariate_correlation(df_idp, df)
    df_corr.to_csv(out("table_corr.csv"))
    df_p.to_csv(out("table_p.csv"))
    df_log_p.to_csv(out("table_log_p.csv"))
    p_bonf, p_fdr = significance_thresholds(df_p.values)

    # Step 6: Manhattan plot (:328-413)
    category = np.array([d_cat.get(int(c[1].split("-")[0]), -1)
                         for c in df.columns])
    manhattan_plot(df_log_p, category, ukb_catname, p_bonf, p_fdr,
                   out("manhattan.png"))

    # Step 7: top hits (:415-536) — tidy CSV + the reference's LaTeX form
    hits = top_hits_table(df_corr, df_p, field_names, p_bonf)
    hits.to_csv(out("top_hits.csv"), index=None)
    try:
        # render BEFORE opening: if to_latex raises (needs jinja2 on some
        # pandas versions) no zero-byte .tex artefact is left behind
        tex = hits.to_latex(index=False, float_format="%.3g")
    except ImportError:
        tex = None
    if tex is not None:
        with open(out("top_hits.tex"), "w") as f:
            f.write(tex)


if __name__ == "__main__":
    main()
