"""The port's PheWAS (``assoc/``) and its CLI against the JAX package's.

The port's ``assoc`` is a copy of the JAX package's host numpy, scipy and
pandas code in float64, so the bound is equality: every step's arrays
and frames equal (``assert_array_equal``, NaNs in the same places), and
the CLI's CSV and LaTeX outputs byte-identical, on one synthetic UK
Biobank-shaped table (``chip_smoke.phewas_tables``: two-row headers, the
confounder fields, ordinal fields with negative "do not know" codes,
missing values, planted associations).
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from ukbb_cardiac_tpu import assoc as jassoc
from ukbb_cardiac_tpu.cli import perform_phenome_wide_association as jcli
from ukbb_cardiac_tpu_torch import assoc as tassoc
from ukbb_cardiac_tpu_torch.assoc import phewas as tphewas
from ukbb_cardiac_tpu_torch.cli import perform_phenome_wide_association as tcli

import chip_smoke

torch.set_num_threads(1)

N_SUBJECTS, N_FIELDS, N_IDP = 400, 40, 8
OUTPUTS = ("confounders.csv", "normalised_non_IDPs.csv", "normalised_IDPs.csv",
           "beta_IDPs.csv", "table_corr.csv", "table_p.csv",
           "table_log_p.csv", "top_hits.csv", "top_hits.tex")


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("phewas"))
    return chip_smoke.phewas_tables(root, N_SUBJECTS, N_FIELDS, N_IDP)


@pytest.fixture(scope="module")
def cli_outputs(tables, tmp_path_factory):
    idp, pheno, _ = tables
    out = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        out[name] = str(tmp_path_factory.mktemp(name))
        cli.main(["--idp_csv", idp, "--pheno_csv", *pheno,
                  "--output_dir", out[name]])
    return out


@pytest.mark.parametrize("name", OUTPUTS)
def test_cli_outputs_byte_identical(cli_outputs, name):
    with open(os.path.join(cli_outputs["jax"], name), "rb") as f:
        want = f.read()
    with open(os.path.join(cli_outputs["port"], name), "rb") as f:
        assert f.read() == want
    assert os.path.exists(os.path.join(cli_outputs["port"], "manhattan.png"))


def test_planted_associations_are_the_top_hits(tables, cli_outputs):
    hits = pd.read_csv(os.path.join(cli_outputs["port"], "top_hits.csv"))
    top = hits.sort_values("p").head(chip_smoke.PHEWAS_PLANTED)
    planted = {(idp, int(col.split("-")[0])) for idp, col in tables[2]}
    assert set(zip(top["IDP"], top["FieldID"])) == planted


def _load(tables):
    idp, pheno, _ = tables
    df_idp = pd.read_csv(idp, index_col=0)
    df = pd.concat([pd.read_csv(p, header=[0, 1], index_col=0)
                    for p in pheno], axis=1).loc[df_idp.index]
    return df_idp, df


def _steps(mod, tables):
    """The CLI's steps through one package's ``assoc``; every
    intermediate, by name."""
    df_idp, df = _load(tables)
    out = {"age_by_date": mod.age_by_date(df)}
    conf, valid = mod.build_confounders(df)
    out["confounders"], out["valid"] = conf, valid
    df, df_idp, conf = df[valid], df_idp[valid], conf[valid]
    df = df.drop(columns=[c for c in df.columns if c[1].split("-")[0] in
                          ("31", "34", "52", "53", "21003", "21002",
                           "21001")])
    df = mod.clean_columns(df)
    out["clean_columns"] = df
    df = mod.normalise_non_idps(df, mod.load_continuous_map())
    out["normalise_non_idps"] = df
    df_idp, beta = mod.deconfound_idps(df_idp, conf)
    out["deconfound_idps"], out["beta"] = df_idp, beta
    corr, p, log_p = mod.univariate_correlation(df_idp, df)
    out["corr"], out["p"], out["log_p"] = corr, p, log_p
    out["thresholds"] = np.array(mod.significance_thresholds(p.values))
    out["top_hits"] = mod.top_hits_table(corr, p, mod.load_field_names(),
                                         out["thresholds"][0])
    return out


@pytest.fixture(scope="module")
def steps(tables):
    return {"jax": _steps(jassoc, tables), "port": _steps(tassoc, tables)}


STEP_NAMES = ("age_by_date", "confounders", "valid", "clean_columns",
              "normalise_non_idps", "deconfound_idps", "beta", "corr", "p",
              "log_p", "thresholds", "top_hits")


@pytest.mark.parametrize("name", STEP_NAMES)
def test_steps_equal_jax(steps, name):
    want, got = steps["jax"][name], steps["port"][name]
    if isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want, check_exact=True)
    else:
        np.testing.assert_array_equal(got, want)


def test_helpers_and_loaders_equal_jax():
    rng = np.random.RandomState(5)
    x = np.round(rng.exponential(size=301), 1)       # with ties
    np.testing.assert_array_equal(tassoc.rank_normalise(x),
                                  jassoc.rank_normalise(x))
    np.testing.assert_array_equal(tassoc.normalise(x), jassoc.normalise(x))
    X, Y = rng.randn(120, 5), rng.randn(120, 6)
    X[rng.rand(120, 5) < 0.1] = np.nan
    Y[:, 0] = 1e7 + X[:, 0]                          # a large-mean column
    for got, want in zip(tassoc.masked_pearson(X, Y),
                         jassoc.masked_pearson(X, Y)):
        np.testing.assert_array_equal(got, want)
    assert tassoc.load_field_names() == jassoc.load_field_names()
    assert tassoc.load_field_categories() == jassoc.load_field_categories()
    pd.testing.assert_frame_equal(tassoc.load_continuous_map(),
                                  jassoc.load_continuous_map())
    # the port reads its own copy of the tables
    assert os.path.dirname(tphewas.DEFAULT_FIELD_NAMES_TSV).endswith(
        os.path.join("ukbb_cardiac_tpu_torch", "assoc", "data"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fdr_equals_jax(seed):
    rng = np.random.RandomState(seed)
    p = np.concatenate([rng.uniform(0, 1e-4, 40), rng.uniform(0, 1, 400),
                        np.full(5, 0.01)])           # ties
    np.testing.assert_array_equal(tassoc.p_adjust_fdr(p),
                                  jassoc.p_adjust_fdr(p))
    p_nan = np.append(p, [np.nan] * 7)
    for q in (0.05, 0.01):
        assert tassoc.fdr_threshold(p_nan, q) == jassoc.fdr_threshold(p_nan, q)
    assert tassoc.fdr_threshold(np.ones(10), 0.05) == (0, 0)
