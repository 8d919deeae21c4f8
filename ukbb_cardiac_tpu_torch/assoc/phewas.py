"""Phenome-wide association study (PheWAS) pipeline.

A copy of ``ukbb_cardiac_tpu/assoc/phewas.py`` (the port imports nothing
of the JAX package; this module never needed JAX): host numpy, scipy and
pandas in float64, so its tables equal the JAX package's.  It reads the
port's own copy of the metadata tables under ``assoc/data/``.

Twin of ``assoc/perform_phenome_wide_association.py`` restructured from a
monolithic script into composable steps:

  1. load imaging phenotypes (IDPs) and per-category non-imaging CSVs
  2. confounders: sex, age-by-date, sex*age, weight, height (:119-147)
  3. cleaning: drop non-numeric / >90% missing / >95% constant /
     corr>0.9999 duplicate columns (:172-224)
  4. normalise: z-score for continuous fields, rank-based inverse-normal
     otherwise (:38-63, FSLNets inormal)
  5. de-confound IDPs by pinv regression (:253-269)
  6. univariate Pearson correlation M x N with p-values (:274-310) —
     VECTORISED: pairwise-deletion correlations computed with six masked
     matmuls instead of the reference's M*N python loop
  7. Bonferroni + FDR thresholds (:312-325) and a Manhattan plot (:328-413)

UKB field-category tables are supplied as files (the reference hard-codes
them in ``data/ukb_field_categories.py``); see ``load_field_categories``.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import pandas as pd
import scipy.special
import scipy.stats

from ukbb_cardiac_tpu_torch.assoc.fdr import fdr_threshold


# -- step 4 helpers ---------------------------------------------------------

def normalise(x):
    """Z-score (``perform_phenome_wide_association.py:33-34``)."""
    return (x - np.mean(x)) / np.std(x)


def rank_normalise(x):
    """Rank-based inverse normal transform (FSLNets inormal, :38-63):
    tied values share their mean rank; Blom offset c = 3/8."""
    x = np.asarray(x, dtype=float)
    ri = np.argsort(np.argsort(x)).astype(float)
    u, inv_idx = np.unique(x, return_inverse=True)
    sii = np.sort(inv_idx)
    repeated_idx = np.unique(sii[np.diff(np.append(sii, 1)) == 0])
    for i in repeated_idx:
        ri[inv_idx == i] = np.mean(ri[inv_idx == i])
    N = len(x)
    ri = ri + 1
    c = 3.0 / 8
    p = (ri - c) / (N - 2 * c + 1)
    return math.sqrt(2) * scipy.special.erfinv(2 * p - 1)


# -- step 2/3: confounders --------------------------------------------------

def age_by_date(df: pd.DataFrame) -> np.ndarray:
    """Age computed from birth year/month vs assessment date
    (more accurate than the floored 21003-2.0 field, :119-128)."""
    age = np.full(len(df), np.nan)
    for i in range(len(df)):
        y = df.iloc[i]["Year of birth", "34-0.0"]
        m = df.iloc[i]["Month of birth", "52-0.0"]
        s = df.iloc[i]["Date of attending assessment centre", "53-2.0"]
        try:
            d1 = datetime.date(int(y), int(m), 15)
            d2 = datetime.date(int(s[:4]), int(s[5:7]), int(s[8:10]))
        except (ValueError, TypeError, IndexError):
            continue  # missing birth/assessment fields -> NaN age; the
            #           caller's valid mask drops the subject (reference
            #           behaviour would crash here)
        age[i] = np.round((d2 - d1).days / 365.25, 1)
    return age


CONFOUNDER_COLUMNS = ["Sex", "Age", "Sex * Age", "Weight", "Height"]


def build_confounders(df: pd.DataFrame):
    """Confounder matrix (sex, age, sex*age, weight, height) and the
    valid-row mask (:129-147)."""
    sex = df["Sex", "31-0.0"].values.astype(float)
    age = age_by_date(df)
    weight = df["Weight", "21002-2.0"].values.astype(float)
    bmi = df["Body mass index (BMI)", "21001-2.0"].values.astype(float)
    height = np.round(np.sqrt(weight / bmi) * 100)
    valid = (~np.isnan(age) & ~np.isnan(sex) & ~np.isnan(weight)
             & ~np.isnan(height))
    conf = np.stack((sex, age, sex * age, weight, height), axis=1)
    return conf, valid


# -- step 4.1: cleaning -----------------------------------------------------

def clean_columns(df: pd.DataFrame, missing_frac: float = 0.9,
                  constant_frac: float = 0.95,
                  dup_corr: float = 0.9999) -> pd.DataFrame:
    """Column cleaning (:172-224): negatives→NaN; drop non-numeric,
    mostly-missing, near-constant and duplicate columns (SIGNED
    r > 0.9999, matching the reference's ``cc > 0.9999`` at :213 —
    anti-correlated recodings are deliberately both kept)."""
    df = df.copy()
    n_subj, n_col = df.shape
    bad = set()
    for i in range(n_col):
        if not np.issubdtype(df.dtypes.iloc[i], np.number):
            bad.add(i)
            continue
        val = df.iloc[:, i].values.astype(float)
        val[val < 0] = np.nan
        # isetitem replaces the column wholesale — df.iloc[:, i] = val
        # raises TypeError under pandas 3 when the column dtype is int
        # and val carries NaNs (real UKB int-coded fields do)
        df.isetitem(i, val)
        valid = ~np.isnan(val)
        if np.sum(valid) < (1 - missing_frac) * n_subj:
            bad.add(i)
            continue
        vu, counts = np.unique(val[valid], return_counts=True)
        if len(counts) and np.max(counts) >= constant_frac * np.sum(valid):
            bad.add(i)

    cols = [i for i in range(n_col) if i not in bad]
    vals = df.iloc[:, cols].values.astype(float)
    corr, _ = masked_pearson(vals, vals)
    for a in range(len(cols)):
        for b in range(a + 1, len(cols)):
            if cols[a] in bad or cols[b] in bad:
                continue
            if corr[a, b] > dup_corr:
                na = np.sum(~np.isnan(vals[:, a]))
                nb = np.sum(~np.isnan(vals[:, b]))
                bad.add(cols[b] if na > nb else cols[a])

    keep = sorted(set(range(n_col)) - bad)
    out = df.iloc[:, keep]
    print(f"{out.shape[1]} columns kept after data cleaning.")
    return out


# -- step 4.3/4.4 -----------------------------------------------------------

def normalise_non_idps(df: pd.DataFrame, continuous_map: pd.DataFrame) -> pd.DataFrame:
    """Per-column z-score (continuous) or rank-inverse-normal (:238-250)."""
    df = df.copy()
    for i in range(df.shape[1]):
        val = df.iloc[:, i].values.astype(float)
        valid = ~np.isnan(val)
        field_id = int(df.columns[i][1].split("-")[0])
        try:
            is_cont = bool(continuous_map.loc[field_id]["continuous"])
        except KeyError:
            is_cont = False
        x = val[valid]
        val[valid] = normalise(x) if is_cont else rank_normalise(x)
        df.isetitem(i, val)  # pandas-3-safe (see clean_columns)
    return df


def deconfound_idps(df_idp: pd.DataFrame, conf: np.ndarray):
    """Regress out confounders from each IDP and z-score (:253-269).
    Returns (deconfounded df, beta matrix)."""
    df_idp = df_idp.copy()
    conf = (conf - np.mean(conf, axis=0)) / np.std(conf, axis=0)
    n_row = conf.shape[1]
    n_col = df_idp.shape[1]
    beta = np.zeros((n_row, n_col))
    for i in range(n_col):
        val = df_idp.iloc[:, i].values.astype(float)
        valid = ~np.isnan(val)
        x = val[valid]
        beta[:, i] = np.dot(np.linalg.pinv(conf[valid]), x)
        x = x - np.dot(conf[valid], beta[:, i])
        val[valid] = normalise(x)
        df_idp.isetitem(i, val)  # pandas-3-safe (see clean_columns)
    return df_idp, beta


# -- step 5: vectorised masked correlation ----------------------------------

def masked_pearson(X: np.ndarray, Y: np.ndarray):
    """Pairwise-deletion Pearson correlation between columns of X (n x M)
    and Y (n x N) with NaNs, as masked matmuls.

    Equivalent to the reference's per-pair scipy.stats.pearsonr loop
    (:280-290) but ~10^4x fewer interpreter iterations; returns (r, p)
    with the two-sided t-test p-value."""
    MX = (~np.isnan(X)).astype(np.float64)
    MY = (~np.isnan(Y)).astype(np.float64)
    # r is shift-invariant, so center each column on its observed mean
    # first: the one-pass sxx - sx^2/n formula on raw values loses all
    # precision for large-mean columns (r off by 20% at mean ~5e6, NaN
    # at ~2e8 — measured), and UKB fields include such codes
    with np.errstate(invalid="ignore"):
        X = X - np.nanmean(X, axis=0, keepdims=True)
        Y = Y - np.nanmean(Y, axis=0, keepdims=True)
    X0 = np.nan_to_num(X, nan=0.0)
    Y0 = np.nan_to_num(Y, nan=0.0)

    n = MX.T @ MY                      # pairwise counts
    sx = X0.T @ MY                     # sum x over joint support
    sy = MX.T @ Y0
    sxx = (X0 * X0).T @ MY
    syy = MX.T @ (Y0 * Y0)
    sxy = X0.T @ Y0

    with np.errstate(invalid="ignore", divide="ignore"):
        cov = sxy - sx * sy / n
        vx = sxx - sx * sx / n
        vy = syy - sy * sy / n
        r = cov / np.sqrt(vx * vy)
        r = np.clip(r, -1.0, 1.0)
        dfree = n - 2
        t = r * np.sqrt(dfree / np.maximum(1 - r * r, 1e-300))
        p = 2 * scipy.stats.t.sf(np.abs(t), np.maximum(dfree, 1))
    p[n < 3] = np.nan
    return r, p


def univariate_correlation(df_idp: pd.DataFrame, df: pd.DataFrame):
    """Step 5 (:274-310): correlation + p tables, p==0 → tiny."""
    corr, corr_p = masked_pearson(df_idp.values.astype(float),
                                  df.values.astype(float))
    corr_p[corr_p == 0] = np.finfo(np.float64).tiny
    log_corr_p = -np.log10(corr_p)
    df_corr = pd.DataFrame(corr, index=df_idp.columns, columns=df.columns)
    df_p = pd.DataFrame(corr_p, index=df_idp.columns, columns=df.columns)
    df_log_p = pd.DataFrame(log_corr_p, index=df_idp.columns, columns=df.columns)
    return df_corr, df_p, df_log_p


def significance_thresholds(corr_p: np.ndarray, alpha: float = 0.05):
    """Step 5b (:312-325): Bonferroni and Nichols-FDR thresholds."""
    M, N = corr_p.shape
    p_bonf = alpha / (M * N)
    p_fdr, _ = fdr_threshold(corr_p.flatten(), alpha)
    print(f"p_bonf = {p_bonf}")
    print(f"p_fdr = {p_fdr}")
    print("Number of correlations reaching Bonferroni threshold = {0}".format(
        np.sum(corr_p < p_bonf)))
    print("Number of correlations reaching FDR threshold = {0}".format(
        np.sum(corr_p < p_fdr)))
    return p_bonf, p_fdr


# -- field-category metadata ------------------------------------------------
#
# The reference ships this metadata as repo assets: the 14 recommended
# categories + smoking (``data/ukb_field_categories.py:1-108``), the
# field-description table (``assoc/ukb_field_added.txt``) and the
# continuous-field map (``assoc/continuous.csv``).  The same payload ships
# here under ``assoc/data/`` so the PheWAS runs with zero user-supplied
# metadata; every loader accepts a path override.

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
DEFAULT_FIELD_NAMES_TSV = os.path.join(_DATA_DIR, "ukb_field_added.txt")
DEFAULT_CATEGORIES_TSV = os.path.join(_DATA_DIR, "ukb_field_categories.tsv")
DEFAULT_CONTINUOUS_CSV = os.path.join(_DATA_DIR, "continuous.csv")


def load_field_names(path: Optional[str] = None) -> Dict[int, str]:
    """Field-ID → description from a tab-separated file with columns
    (category id, field id, category name, field description) — the format
    of the reference's ``ukb_field_added.txt`` (:100-107).  Defaults to
    the copy shipped under ``assoc/data/``."""
    import csv

    field_names = {}
    with open(path or DEFAULT_FIELD_NAMES_TSV, "r", encoding="latin-1") as f:
        for row in csv.reader(f, delimiter="\t"):
            if len(row) >= 4:
                field_names[int(row[1])] = row[3]
    return field_names


def load_field_categories(path: Optional[str] = None
                          ) -> Tuple[Dict[int, list], Dict[int, str]]:
    """Category-ID → field-ID list and category-ID → name, from a TSV with
    columns (category id, field id, category name[, ...]).  Defaults to
    the shipped ``assoc/data/ukb_field_categories.tsv`` — the reference's
    recommended-category tables (``data/ukb_field_categories.py``)."""
    import csv

    cat: Dict[int, list] = {}
    catname: Dict[int, str] = {}
    with open(path or DEFAULT_CATEGORIES_TSV, "r", encoding="latin-1") as f:
        for row in csv.reader(f, delimiter="\t"):
            if len(row) >= 3 and not row[0].startswith("#"):
                cid, fid = int(row[0]), int(row[1])
                cat.setdefault(cid, []).append(fid)
                catname[cid] = row[2]
    return cat, catname


def load_continuous_map(path: Optional[str] = None) -> pd.DataFrame:
    """Field-ID → is-continuous table (``assoc/continuous.csv``)."""
    return pd.read_csv(path or DEFAULT_CONTINUOUS_CSV, index_col=0)


# -- step 6: Manhattan plot -------------------------------------------------

def manhattan_plot(df_log_p: pd.DataFrame, category: np.ndarray,
                   catname: Dict[int, str], p_bonf: float, p_fdr: float,
                   output_path: str, idp_row: Optional[int] = None) -> None:
    """Manhattan plot of -log10(p) coloured by category (:328-413),
    drawn with plain matplotlib (the reference uses seaborn)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    log_p = df_log_p.values
    if idp_row is not None:
        log_p = log_p[idp_row:idp_row + 1]
    y = np.nanmax(log_p, axis=0)
    cats = np.asarray(category)
    uniq = sorted(set(cats.tolist()))
    cmap = plt.get_cmap("tab20")

    plt.figure(figsize=(12, 4))
    x0 = 0
    ticks, tick_labels = [], []
    for k, cid in enumerate(uniq):
        sel = np.nonzero(cats == cid)[0]
        xs = x0 + np.arange(len(sel))
        plt.scatter(xs, y[sel], s=8, color=cmap(k % 20),
                    label=catname.get(cid, str(cid)))
        ticks.append(x0 + len(sel) / 2)
        tick_labels.append(catname.get(cid, str(cid)))
        x0 += len(sel)
    if p_bonf > 0:
        plt.axhline(-np.log10(p_bonf), color="red", ls="--", lw=1,
                    label="Bonferroni")
    if p_fdr > 0:  # fdr_threshold returns 0 when nothing passes
        plt.axhline(-np.log10(p_fdr), color="orange", ls="--", lw=1,
                    label="FDR")
    plt.xticks(ticks, tick_labels, rotation=60, ha="right", fontsize=7)
    plt.ylabel("-log10(p)")
    plt.tight_layout()
    plt.savefig(output_path, dpi=150)
    plt.close()


def top_hits_table(df_corr: pd.DataFrame, df_p: pd.DataFrame,
                   field_names: Dict[int, str], p_thres: float,
                   top_k: int = 20,
                   latex_path: str = None) -> pd.DataFrame:
    """Strongest significant associations per IDP (the reference emits
    LaTeX tables, :415-536; we emit a tidy DataFrame and, when
    ``latex_path`` is given, the LaTeX rendering of it too)."""
    rows = []
    for i, idp in enumerate(df_corr.index):
        p_row = df_p.iloc[i].values
        r_row = df_corr.iloc[i].values
        sel = np.nonzero(p_row < p_thres)[0]
        sel = sel[np.argsort(-np.abs(r_row[sel]))][:top_k]
        for j in sel:
            field_col = df_p.columns[j]
            fid = int(field_col[1].split("-")[0]) if isinstance(
                field_col, tuple) else -1
            rows.append({"IDP": idp,
                         "Field": field_names.get(fid, str(field_col)),
                         "FieldID": fid, "r": r_row[j], "p": p_row[j]})
    df = pd.DataFrame(rows)
    if latex_path:
        with open(latex_path, "w") as f:
            f.write(df.to_latex(index=False, float_format="%.3g"))
    return df
