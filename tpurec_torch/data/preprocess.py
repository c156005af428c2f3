"""Offline preprocessing: Amazon + Ali-CCP (the port's copy of
``tpurec/data/preprocess.py``, run on the host with pandas).

It gives the JAX package's frames and files for the same inputs: the same
pandas operations, the same ``np.random.default_rng(seed)`` draws in the
same order, and, where the JAX package bins Ali-CCP's dense columns with
scikit-learn's ``KBinsDiscretizer``, :class:`_KBinsDiscretizer`, a numpy
copy of scikit-learn 1.9.0's ordinal KBins (the port imports no
scikit-learn).

Amazon (the reference's preprocess.py:124-251,425-481):
  chunked ratings filter to the last N months -> k-core filter ->
  streaming metadata join (price/rank/brand/category) -> label = rating>4 ->
  label-encode ids -> domain = first category tag (25 named categories) ->
  log2-spaced binning of sales_rank/price -> weekday -> csv.

Ali-CCP (the reference's preprocess.py:253-414,482-496):
  raw skeleton+common-features -> per-split csv; KBins(10, fit on train)
  over 8 dense cols; user/item frequency filter; per-domain nunique
  filter; 6 domain-sampling strategies (nlargest/random/interval/
  weighted/interval_random/mix_interval_random); re-encode ids; train_tag.
"""

from __future__ import annotations

import json
import os
import re
from collections import defaultdict
from datetime import datetime, timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd


# dataset fact: the 25 Amazon first-category domains ordered by volume
# (preprocess.py:37-45)
AMAZON_DOMAIN2ENCODER: Dict[str, int] = {
    "Clothing, Shoes & Jewelry": 0, "Home & Kitchen": 1, "Books": 2,
    "Electronics": 3, "Sports & Outdoors": 4, "Tools & Home Improvement": 5,
    "Pet Supplies": 6, "Automotive": 7, "Grocery & Gourmet Food": 8,
    "Patio, Lawn & Garden": 9, "Office Products": 10, "Toys & Games": 11,
    "Cell Phones & Accessories": 12, "Movies & TV": 13,
    "Arts, Crafts & Sewing": 14, "Industrial & Scientific": 15,
    "Kindle Store": 16, "Musical Instruments": 17, "Appliances": 18,
    "CDs & Vinyl": 19, "Video Games": 20, "Gift Cards": 21,
    "Magazine Subscriptions": 22, "Home & Business Services": 23,
    "Collectibles & Fine Art": 24,
}

ALICCP_CATEGORICAL = [
    "101", "121", "122", "124", "125", "126", "127", "128", "129", "205",
    "206", "207", "210", "216", "508", "509", "702", "853", "109_14",
    "110_14", "127_14", "150_14", "301",
]
ALICCP_DENSE = ["D109_14", "D110_14", "D127_14", "D150_14", "D508", "D509",
                "D702", "D853"]


class _KBinsDiscretizer:
    """scikit-learn 1.9.0's ``KBinsDiscretizer(n_bins, encode="ordinal",
    strategy, subsample)`` on one column, in numpy, bin for bin.

    - fit keeps a float32 or integer column's dtype (``check_array`` with
      ``dtype="numeric"``): float32 min/max give float32 uniform edges;
    - a constant column gets the edges ``[-inf, inf]`` (one bin, all 0);
    - ``quantile``: ``np.percentile`` with ``"averaged_inverted_cdf"`` as
      float64, then every edge within 1e-8 of the one before is dropped;
    - ``kmeans``: one-column ``KMeans(n_bins, init=<the uniform bins'
      midpoints>, n_init=1)`` (Lloyd, ``max_iter`` 300, tolerance 1e-4 of
      the column's variance, the column centred by its mean; the port's
      k-means steps, :func:`tpurec_torch.cdc.algorithm.
      _kmeans_single_lloyd`), in float32 for a float32 column and float64
      otherwise; the sorted centres' midpoints between the column's min and
      max are the edges, then every edge within 1e-8 of the one before is
      dropped.  Up to 256 rows the sums are scikit-learn's; above, it sums
      chunks of 256 rows on several threads, in an order no copy follows,
      and the edges part by rounding;
    - above ``subsample`` rows the fit draws ``np.random.choice(n,
      subsample, replace=True)`` from numpy's global state, as
      scikit-learn's ``resample`` does with ``random_state=None``;
    - transform casts a column that is neither float64 nor float32 to
      float64 and takes ``np.searchsorted(edges[1:-1], x, side="right")``.
    """

    def __init__(self, n_bins: int = 10, strategy: str = "uniform",
                 subsample: Optional[int] = None):
        if strategy not in ("uniform", "quantile", "kmeans"):
            raise ValueError(f"strategy must be 'uniform', 'quantile' or "
                             f"'kmeans', got {strategy!r}")
        self.n_bins = n_bins
        self.strategy = strategy
        self.subsample = subsample

    @staticmethod
    def _column(x, keep) -> np.ndarray:
        """``x`` (a Series, a one-column frame or an array) as 1-D numpy,
        cast to float64 unless its dtype is in ``keep``; no rows, NaN or
        inf raise ValueError, as scikit-learn's input check does."""
        x = np.asarray(x)
        if len(x) == 0:
            raise ValueError("Found array with 0 sample(s); a minimum of 1 "
                             "is required.")
        x = x.reshape(len(x), -1)
        if x.shape[1] != 1:
            raise ValueError(f"one column expected, got {x.shape[1]}")
        x = x[:, 0]
        if x.dtype not in keep:
            x = x.astype(np.float64)
        if x.dtype.kind == "f" and not np.isfinite(x).all():
            raise ValueError("Input X contains NaN or infinity.")
        return x

    def fit(self, x) -> "_KBinsDiscretizer":
        x = np.asarray(x)
        x = self._column(x, (x.dtype,) if x.dtype.kind in "biuf" else ())
        if self.subsample is not None and len(x) > self.subsample:
            x = x[np.random.choice(len(x), size=self.subsample,
                                   replace=True)]
        lo, hi = x.min(), x.max()
        if lo == hi:
            self.bin_edges_ = np.array([-np.inf, np.inf])
        elif self.strategy == "uniform":
            self.bin_edges_ = np.linspace(lo, hi, self.n_bins + 1)
        else:
            edges = (self._kmeans_edges(x, lo, hi)
                     if self.strategy == "kmeans" else np.asarray(
                         np.percentile(x, np.linspace(0, 100,
                                                      self.n_bins + 1),
                                       method="averaged_inverted_cdf"),
                         dtype=np.float64))
            self.bin_edges_ = edges[
                np.ediff1d(edges, to_begin=np.inf) > 1e-8]
        self.n_bins_ = len(self.bin_edges_) - 1
        return self

    def _kmeans_edges(self, x, lo, hi) -> np.ndarray:
        """scikit-learn's ``"kmeans"`` edges of the column ``x`` (min
        ``lo``, max ``hi``) before narrow bins are dropped."""
        from tpurec_torch.cdc.algorithm import (KMEANS_TOL,
                                                _kmeans_single_lloyd)

        k = self.n_bins
        if len(x) < k:
            raise ValueError(f"n_samples={len(x)} should be >= "
                             f"n_clusters={k}.")
        uniform = np.linspace(lo, hi, k + 1)
        X = np.array(x[:, None], order="C", dtype=(
            x.dtype if x.dtype in (np.float32, np.float64) else np.float64))
        centers = np.array((uniform[1:] + uniform[:-1])[:, None] * 0.5,
                           dtype=X.dtype)
        tol = np.mean(np.var(X, axis=0)) * KMEANS_TOL
        mean = X.mean(axis=0)
        X -= mean
        centers -= mean
        centers = _kmeans_single_lloyd(X, centers, tol)[2]
        centers += mean
        centers = centers[:, 0]
        centers.sort()
        return np.r_[lo, (centers[1:] + centers[:-1]) * 0.5, hi]

    def transform(self, x) -> np.ndarray:
        """-> the int bin of each row, as ``transform(...).astype(int)``."""
        x = self._column(x, (np.dtype(np.float64), np.dtype(np.float32)))
        return np.searchsorted(self.bin_edges_[1:-1], x,
                               side="right").astype(int)


def reduce_mem(df: pd.DataFrame) -> pd.DataFrame:
    """Downcast numeric columns to the smallest dtype that holds their range
    (the well-known pandas memory reducer the reference imports from its
    missing dataset module, run.py:27)."""
    for col in df.columns:
        t = df[col].dtype
        if not pd.api.types.is_numeric_dtype(t):
            continue
        cmin, cmax = df[col].min(), df[col].max()
        if pd.api.types.is_integer_dtype(t):
            for cand in (np.int8, np.int16, np.int32, np.int64):
                info = np.iinfo(cand)
                if cmin >= info.min and cmax <= info.max:
                    df[col] = df[col].astype(cand)
                    break
        else:
            for cand in (np.float32, np.float64):
                info = np.finfo(cand)
                if cmin >= info.min and cmax <= info.max:
                    df[col] = df[col].astype(cand)
                    break
    return df


def _label_encode(series: pd.Series) -> Tuple[pd.Series, Dict]:
    cats = pd.Series(series.astype(str).unique()).sort_values().tolist()
    mapping = {v: i for i, v in enumerate(cats)}
    return series.astype(str).map(mapping), mapping


# ---------------------------------------------------------------------------
# Amazon
# ---------------------------------------------------------------------------


def process_price(price_str) -> Optional[float]:
    """'$12.99' -> 13; '$10 - $20' -> mean, ceiled (preprocess.py:65-78)."""
    try:
        if not isinstance(price_str, str) or price_str == "":
            return None
        cleaned = re.sub(r"[^\d.\-]", "", price_str)
        if "-" in cleaned:
            parts = [p for p in cleaned.split("-") if p]
            price = float(np.mean([float(p) for p in parts]))
        else:
            price = float(cleaned)
        return float(np.ceil(price))
    except (ValueError, ZeroDivisionError):
        return None


def process_rank(sales_rank_str) -> Tuple[Optional[int], Optional[str]]:
    """'#1,234 in Books (See Top 100)' -> (1234, 'Books').

    Matches preprocess.py:80-90 exactly, including its strictness: a string
    containing ' in ' more than once (e.g. '... (See Top 100 in Books)')
    fails the 2-way unpack and yields (None, None), as in the reference.
    """
    if not isinstance(sales_rank_str, str):
        return None, None
    try:
        rank_part, chart_part = sales_rank_str.split(" in ")
        rank = int(rank_part.replace(",", "").replace("#", ""))
        chart = chart_part.split(" (")[0]
        return rank, chart
    except ValueError:
        return None, None


def k_core_filter(df: pd.DataFrame, k: int, user_col="userid",
                  item_col="itemid") -> pd.DataFrame:
    """Keep rows whose user AND item appear >= k times (one pass, matching
    preprocess.py:128-133's single-round filter)."""
    if k <= 0:
        return df
    uc = df.groupby(user_col)[user_col].transform("count")
    ic = df.groupby(item_col)[item_col].transform("count")
    return df.loc[(uc >= k) & (ic >= k)].copy()


class AmazonPreprocessor:
    """Amazon ratings + metadata -> training csv (preprocess.py amazon path)."""

    FEATURES = ["userid", "itemid", "weekday", "domain", "sales_chart",
                "sales_rank", "brand", "price"]

    def __init__(self, data_path: str, prepare2train_month: int = 12,
                 k_cores: int = 3, end_date: Optional[int] = None):
        self.data_path = data_path
        self.prepare2train_month = prepare2train_month
        self.k_cores = k_cores
        # reference pins the dataset's end at 2018-08-15 (preprocess.py:439)
        self.end_date = end_date or int(datetime(2018, 8, 15).timestamp())
        self.domain2encoder_dict = dict(AMAZON_DOMAIN2ENCODER)
        self.preprocess_path = os.path.join(
            data_path, f"prepare2train_filter_{prepare2train_month}month.csv"
        )

    # -- stage 1: time-windowed ratings ------------------------------------
    def load_ratings(self, ratings_csv: str, chunksize: int = 5_000_000
                     ) -> pd.DataFrame:
        cols = ["itemid", "userid", "rating", "timestamp"]
        days_n = 30 * self.prepare2train_month + self.prepare2train_month // 2
        start = self.end_date - int(timedelta(days=days_n).total_seconds())
        parts = []
        for chunk in pd.read_csv(ratings_csv, chunksize=chunksize, header=None,
                                 names=cols, on_bad_lines="skip"):
            parts.append(chunk.loc[(chunk["timestamp"] >= start)
                                   & (chunk["timestamp"] < self.end_date)])
        return pd.concat(parts, ignore_index=True)

    # -- stage 2: metadata join --------------------------------------------
    def stream_item_meta(self, meta_json_path: str, wanted_items: set
                         ) -> pd.DataFrame:
        rows = []
        with open(meta_json_path, "rb") as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("asin") not in wanted_items:
                    continue
                rows.append([rec["asin"], rec.get("price"), rec.get("rank"),
                             rec.get("brand"), rec.get("category")])
                if len(rows) >= len(wanted_items):
                    break
        return pd.DataFrame(
            rows, columns=["itemid", "price", "salesRank", "brand", "category"]
        )

    def merge_metadata(self, df: pd.DataFrame, meta_json_path: str
                       ) -> pd.DataFrame:
        df = k_core_filter(df, self.k_cores)
        unique_items = set(df["itemid"].unique())
        meta = self.stream_item_meta(meta_json_path, unique_items)

        meta = meta.replace("", None)
        meta["price"] = meta["price"].apply(process_price)
        meta["sales_rank"], meta["sales_chart"] = zip(
            *meta["salesRank"].apply(process_rank)
        )
        # category may arrive as a list or its repr (preprocess.py:168)
        def first_tag(cat):
            if isinstance(cat, str):
                import ast

                try:
                    cat = ast.literal_eval(cat)
                except (ValueError, SyntaxError):
                    return None
            if isinstance(cat, list) and cat:
                return cat[0]
            return None

        meta["domain"] = meta["category"].apply(first_tag)
        # rare brands -> None (preprocess.py:171-173)
        bc = meta["brand"].value_counts()
        rare = set(bc[bc < 10].index)
        meta["brand"] = meta["brand"].apply(lambda b: None if b in rare else b)

        # label = rating > 4.0 (preprocess.py:176-178)
        df["label"] = (df["rating"] > 4.0).astype(int)

        # encode itemid jointly (preprocess.py:180-184)
        enc, _ = _label_encode(pd.Series(sorted(unique_items)))
        item_map = {v: i for i, v in
                    enumerate(sorted(str(x) for x in unique_items))}
        df["itemid"] = df["itemid"].astype(str).map(item_map)
        meta["itemid"] = meta["itemid"].astype(str).map(item_map)

        df = df.merge(meta.drop(columns=["salesRank", "category"]),
                      on="itemid", how="left")
        dt = pd.to_datetime(df["timestamp"], unit="s")
        df["weekday"] = dt.dt.dayofweek
        return df

    # -- stage 3: binning + encoding ---------------------------------------
    def finalize(self, df: pd.DataFrame) -> pd.DataFrame:
        # log2-spaced bins (preprocess.py:459-465)
        df["sales_rank"] = df["sales_rank"].fillna(
            df["sales_rank"].quantile()).astype(int)
        rank_bins = [0] + list(np.exp2(np.arange(2, 21, 2)).astype(int)) + [np.inf]
        df["sales_rank"] = pd.cut(df["sales_rank"], bins=rank_bins, labels=False)

        df["price"] = df["price"].fillna(df["price"].quantile()).astype(int)
        price_bins = [-1] + list(np.exp2(np.arange(1, 13, 1.2)).astype(int)) + [np.inf]
        df["price"] = pd.cut(df["price"], bins=price_bins, labels=False)
        df["timestamp"] = df["timestamp"].astype(int)

        for fea in ["userid", "weekday", "sales_chart", "brand"]:
            df[fea] = df[fea].fillna("-1")
            df[fea], _ = _label_encode(df[fea])

        df = df.dropna(subset=["domain"])
        df["domain"] = df["domain"].map(self.domain2encoder_dict)
        df = df.dropna(subset=["domain"])
        df["domain"] = df["domain"].astype(int)
        return df[self.FEATURES + ["label", "timestamp"]]

    def main(self, ratings_csv: str, meta_json_path: str) -> pd.DataFrame:
        if os.path.exists(self.preprocess_path):
            return pd.read_csv(self.preprocess_path)
        df = self.load_ratings(ratings_csv)
        df = self.merge_metadata(df, meta_json_path)
        out = self.finalize(df)
        out.to_csv(self.preprocess_path, index=False)
        return out


# ---------------------------------------------------------------------------
# Ali-CCP
# ---------------------------------------------------------------------------


def convert_raw_aliccp(
    skeleton_path: str,
    common_features_path: str,
    out_csv: str,
    categorical: Sequence[str] = tuple(ALICCP_CATEGORICAL),
    val_fraction: float = 0.0,
    val_out_csv: Optional[str] = None,
) -> None:
    """Raw Ali-CCP -> flat csv — the capability of the reference's missing
    ``preprocess_ali_ccp.py`` (preprocess.py:262 "Please run
    preprocess_ali_ccp.py first").

    Raw format: skeleton lines
    ``sample_id,click,conversion,common_feature_index,feature_num,
    feat_list`` where feat_list is ``\x01``-joined ``field:feat_id:value``
    triples; common features live in a second file keyed by
    common_feature_index.  Categorical fields keep the feat_id; the 8 dense
    ``D*`` aggregates keep the value of their paired field.
    """
    import csv

    common: Dict[str, Dict[str, Tuple[str, str]]] = {}
    with open(common_features_path) as f:
        for line in f:
            idx, _num, feats = line.rstrip("\n").split(",", 2)
            fd = {}
            for item in feats.split("\x01"):
                if not item:
                    continue
                field, feat_id, value = item.split(":")
                fd[field] = (feat_id, value)
            common[idx] = fd

    # streamed (the real dataset is ~85M skeleton rows — accumulating rows
    # in Python lists and one giant DataFrame would need tens of GB; this
    # writes as it reads with O(common-features) memory)
    dense_pairs = [(d, d[1:]) for d in ALICCP_DENSE]  # D109_14 <- 109_14
    header = ["click", "purchase"] + list(categorical) + list(ALICCP_DENSE)
    rng = np.random.default_rng(0)
    f_main = open(out_csv, "w", newline="")
    w_main = csv.writer(f_main)
    w_main.writerow(header)
    f_val = w_val = None
    if val_out_csv is not None:
        f_val = open(val_out_csv, "w", newline="")
        w_val = csv.writer(f_val)
        w_val.writerow(header)
    empty: Dict[str, Tuple[str, str]] = {}
    try:
        with open(skeleton_path) as f:
            for line in f:
                sid, click, conv, cfi, _num, feats = \
                    line.rstrip("\n").split(",", 5)
                local: Dict[str, Tuple[str, str]] = {}
                for item in feats.split("\x01"):
                    if not item:
                        continue
                    field, feat_id, value = item.split(":")
                    local[field] = (feat_id, value)
                com = common.get(cfi, empty)
                row = [click, conv]
                for c in categorical:
                    v = local.get(c) or com.get(c)
                    row.append(v[0] if v is not None else "0")
                for _, src in dense_pairs:
                    v = local.get(src) or com.get(src)
                    row.append(v[1] if v is not None else "0.0")
                if (val_fraction > 0 and w_val is not None
                        and rng.random() < val_fraction):
                    w_val.writerow(row)
                else:
                    w_main.writerow(row)
    finally:
        f_main.close()
        if f_val is not None:
            f_val.close()


class AliCCPPreprocessor:
    """KBins-discretize + frequency/domain filtering + domain sampling
    (preprocess.py aliccp path)."""

    def __init__(self, data_path: str, downsample_freq_thresh: int = 10,
                 sample_n_domain: int = 50,
                 sample_mode: str = "mix_interval_random",
                 discrete_method: str = "uniform", seed: int = 2000):
        self.data_path = data_path
        self.thresh = downsample_freq_thresh
        self.n_domain = sample_n_domain
        self.sample_mode = sample_mode
        self.discrete_method = discrete_method
        self.rng = np.random.default_rng(seed)
        self.domain2encoder_dict: Dict[str, int] = {}
        self.preprocess_path = os.path.join(
            data_path,
            f"thresh{downsample_freq_thresh}_ndomain{sample_n_domain}_"
            f"mode{sample_mode}.csv",
        )

    # -- stage 1: discretize dense cols (fit on train only) ----------------
    def discretize(self, dfs: List[pd.DataFrame],
                   columns: Sequence[str] = tuple(ALICCP_DENSE)
                   ) -> List[pd.DataFrame]:
        for col in columns:
            if col not in dfs[0].columns:
                continue
            disc = _KBinsDiscretizer(
                n_bins=10, strategy=self.discrete_method,
                subsample=int(2e5) if self.discrete_method == "quantile" else None,
            )
            disc.fit(dfs[0][col])  # fit on train only (preprocess.py:282)
            for df in dfs:
                df[col] = disc.transform(df[col])
        for df in dfs:
            df.rename(columns={"101": "userid", "205": "itemid",
                               "206": "domain"}, inplace=True)
        return dfs

    # -- stage 2: filtering + domain sampling ------------------------------
    def _select_domains(self, counts: pd.Series, df: pd.DataFrame):
        mode, n_domain = self.sample_mode, self.n_domain
        sorted_domains = counts.index
        if mode == "nlargest":
            return list(counts.nlargest(n_domain).index), df
        if mode == "random":
            remaining = list(df["domain"].unique())
            k = min(n_domain, len(remaining))
            return list(self.rng.choice(remaining, k, replace=False)), df
        if mode == "interval":
            step = max(1, len(sorted_domains) // n_domain)
            return list(sorted_domains[::step][:n_domain]), df
        if mode == "weighted":
            mid = counts.median()
            cf = (counts + 0.2 * mid ** 2 / counts) ** 0.8
            w = cf / cf.sum()
            return list(self.rng.choice(counts.index, n_domain, p=w.values,
                                        replace=False)), df
        if mode == "interval_random":
            cut = int(0.05 * len(sorted_domains))
            large, small = sorted_domains[:cut], sorted_domains[cut:]
            sel = []
            for k, pool in zip([5, n_domain - 5], [large, small]):
                step = max(1, len(pool) // max(k, 1))
                sel.extend(pool[::step][:k])
            return sel, df
        if mode == "mix_interval_random":
            n_mix = int(1.2 * n_domain)
            cut = int(0.05 * len(sorted_domains))
            large, small = sorted_domains[:cut], sorted_domains[cut:]
            tmp = []
            for k, pool in zip([8, n_mix - 8], [large, small]):
                step = max(1, len(pool) // max(k, 1))
                tmp.extend(pool[::step][:k])
            tmp = list(dict.fromkeys(tmp))
            k = min(self.n_domain, len(tmp))
            selected = list(self.rng.choice(len(tmp), k, replace=False))
            selected = [tmp[i] for i in selected]
            mix_source = [d for d in tmp if d not in selected]
            mix_target = list(self.rng.choice(
                np.asarray(selected, dtype=object), len(mix_source), replace=False
            )) if mix_source else []
            mix = dict(zip(mix_source, mix_target))
            if mix:
                df = df.copy()
                df["domain"] = df["domain"].replace(mix)
            return selected, df
        raise ValueError(f"Invalid sample_mode {mode!r}")

    def filter_and_sample(self, dfs: List[pd.DataFrame]) -> pd.DataFrame:
        for tag, df in enumerate(dfs):
            df["train_tag"] = tag  # 0=train 1=val 2=test (preprocess.py:299)
        df = pd.concat(dfs, ignore_index=True)

        uc = df["userid"].value_counts()
        ic = df["itemid"].value_counts()
        valid = (df["userid"].isin(uc[uc >= self.thresh].index)
                 & df["itemid"].isin(ic[ic >= self.thresh].index))
        df = df[valid]

        # per-domain nunique filter (preprocess.py:326-327)
        df = df.groupby("domain").filter(
            lambda x: (x["userid"].nunique() >= self.thresh * 20)
            and (x["itemid"].nunique() >= self.thresh * 20)
        )
        counts = df["domain"].value_counts().sort_values(ascending=False)

        selected, df = self._select_domains(counts, df)
        df = df[df["domain"].isin(selected)].copy()

        # domains ranked by size -> contiguous ids (preprocess.py:390-396)
        order = df["domain"].value_counts().sort_values(ascending=False).index
        mapping = {d: i for i, d in enumerate(order)}
        self.domain2encoder_dict = {str(d): i for d, i in mapping.items()}
        df["domain"] = df["domain"].map(mapping)

        # re-encode ids after sampling (preprocess.py:398-404)
        for fea in ["userid", "itemid"]:
            df[fea], _ = _label_encode(df[fea])
        return df

    def main(self, train_csv: str, val_csv: str, test_csv: str,
             streaming: Optional[bool] = None,
             chunksize: int = 2_000_000,
             return_frame: bool = True) -> Optional[pd.DataFrame]:
        """``streaming=None`` (default) picks the chunked low-memory path
        whenever it is bit-exact (uniform KBins); ``False`` forces the
        whole-DataFrame path (required for 'quantile' discretization,
        whose subsampling depends on the full column).
        ``return_frame=False`` skips reading the written CSV back —
        callers that only need the file keep the streaming path's
        bounded-memory property."""
        if os.path.exists(self.preprocess_path):
            return pd.read_csv(self.preprocess_path) if return_frame else None
        if streaming is None:
            streaming = self.discrete_method == "uniform"
        if streaming:
            if self.discrete_method != "uniform":
                raise ValueError(
                    "streaming path is only bit-exact for uniform KBins")
            self._run_streaming(train_csv, val_csv, test_csv, chunksize)
            return (pd.read_csv(self.preprocess_path) if return_frame
                    else None)
        dfs = [reduce_mem(pd.read_csv(p)) for p in (train_csv, val_csv, test_csv)]
        dfs = self.discretize(dfs)
        out = self.filter_and_sample(dfs)
        out.to_csv(self.preprocess_path, index=False)
        return out

    # -- streaming path (bounded memory, bit-identical to main) ------------
    #
    # The in-memory path holds all three splits as DataFrames plus a full
    # concat copy (9.3 GB RSS measured at 20M rows in the JAX package);
    # extrapolated, the real 85M-row Ali-CCP needs ~40 GB host RAM.  The
    # streaming rebuild keeps only three compact id columns (user, item,
    # domain) resident and makes two chunked passes over the CSVs:
    #
    #   pass 1: per-column min/max for the KBins fit + the compact id
    #           arrays; all count-based decisions (frequency filter,
    #           per-domain nunique filter, domain sampling, re-encoding)
    #           then run on pandas Series built from those arrays IN THE
    #           SAME ROW ORDER as the in-memory concat, so every
    #           value_counts tie-order and rng draw matches exactly;
    #   pass 2: re-read chunks, apply the precomputed row mask and column
    #           transforms, append to the output CSV.
    #
    # Uniform-strategy KBins depends only on the column min/max, so
    # fitting the same discretizer on the two-row [[min],[max]]
    # frame reproduces the in-memory path's bin edges bit-for-bit
    # (including the reduce_mem float32 round-trip, which is why min/max
    # are taken AFTER the same downcast rule).

    _ID_COLS = ("101", "205", "206")  # userid, itemid, domain (raw names)

    @staticmethod
    def _downcast_float_dtype(cmin: float, cmax: float):
        """The dtype reduce_mem would pick for a float column."""
        f32 = np.finfo(np.float32)
        return np.float32 if (cmin >= f32.min and cmax <= f32.max) else np.float64

    def _fit_discretizers(self, stats: Dict[str, Tuple[float, float]]):
        discs = {}
        for col, (cmin, cmax) in stats.items():
            dt = self._downcast_float_dtype(cmin, cmax)
            # uniform edges depend only on min/max
            discs[col] = _KBinsDiscretizer(n_bins=10, strategy="uniform").fit(
                np.array([cmin, cmax], dtype=dt))
        return discs

    def _run_streaming(self, train_csv: str, val_csv: str, test_csv: str,
                       chunksize: int) -> None:
        paths = (train_csv, val_csv, test_csv)
        dense = [c for c in ALICCP_DENSE
                 if c in pd.read_csv(train_csv, nrows=0).columns]

        # ---- pass 1: stats + compact id columns --------------------------
        users, items, domains = [], [], []
        train_minmax: Dict[str, Tuple[float, float]] = {}
        file_minmax: List[Dict[str, Tuple[float, float]]] = []
        for tag, path in enumerate(paths):
            fmm: Dict[str, Tuple[float, float]] = {}
            for chunk in pd.read_csv(
                    path, chunksize=chunksize,
                    usecols=list(self._ID_COLS) + dense):
                users.append(chunk["101"].to_numpy(np.int64, copy=True))
                items.append(chunk["205"].to_numpy(np.int64, copy=True))
                domains.append(chunk["206"].to_numpy(np.int64, copy=True))
                for c in dense:
                    lo = float(chunk[c].min())
                    hi = float(chunk[c].max())
                    if c in fmm:
                        fmm[c] = (min(fmm[c][0], lo), max(fmm[c][1], hi))
                    else:
                        fmm[c] = (lo, hi)
            file_minmax.append(fmm)
            if tag == 0:
                train_minmax = fmm
        users = pd.Series(np.concatenate(users))
        items = pd.Series(np.concatenate(items))
        domain_s = pd.Series(np.concatenate(domains))
        del domains

        # ---- decisions (same ops, same order as filter_and_sample) -------
        uc = users.value_counts()
        ic = items.value_counts()
        valid = (users.isin(uc[uc >= self.thresh].index)
                 & items.isin(ic[ic >= self.thresh].index)).to_numpy()
        del uc, ic
        sub = pd.DataFrame({"userid": users[valid], "itemid": items[valid],
                            "domain": domain_s[valid]})
        del users, items
        nun = sub.groupby("domain")[["userid", "itemid"]].nunique()
        keep_dom = nun[(nun["userid"] >= self.thresh * 20)
                       & (nun["itemid"] >= self.thresh * 20)].index
        m2 = sub["domain"].isin(keep_dom).to_numpy()
        sub = sub[m2]
        counts = sub["domain"].value_counts().sort_values(ascending=False)

        selected, sub = self._select_domains(counts, sub)
        m3 = sub["domain"].isin(selected).to_numpy()
        sub = sub[m3]

        order = sub["domain"].value_counts().sort_values(ascending=False).index
        dom_map = {d: i for i, d in enumerate(order)}
        self.domain2encoder_dict = {str(d): i for d, i in dom_map.items()}
        final_domain = sub["domain"].map(dom_map).to_numpy(np.int64)
        enc_cols = {}
        for fea in ["userid", "itemid"]:
            enc, _ = _label_encode(sub[fea])
            enc_cols[fea] = enc.to_numpy(np.int64)

        # global keep mask over the concatenated row order
        keep = valid.copy()
        keep[np.flatnonzero(valid)[~m2]] = False
        keep[np.flatnonzero(keep)[~m3]] = False
        assert int(keep.sum()) == len(sub)
        del sub, valid, m2, m3

        discs = self._fit_discretizers({c: train_minmax[c] for c in dense})

        # ---- pass 2: transform + append ----------------------------------
        rename = {"101": "userid", "205": "itemid", "206": "domain"}
        row_off = kept_off = 0
        first = True
        for tag, path in enumerate(paths):
            fmm = file_minmax[tag]
            for chunk in pd.read_csv(path, chunksize=chunksize):
                n = len(chunk)
                cmask = keep[row_off:row_off + n]
                row_off += n
                out = chunk.iloc[np.flatnonzero(cmask)].copy()
                k = len(out)
                out.rename(columns=rename, inplace=True)
                out["userid"] = enc_cols["userid"][kept_off:kept_off + k]
                out["itemid"] = enc_cols["itemid"][kept_off:kept_off + k]
                out["domain"] = final_domain[kept_off:kept_off + k]
                kept_off += k
                for c in dense:
                    # fall back to the train stats for a split whose pass-1
                    # chunks were empty (dtype choice is moot with no rows)
                    dt = self._downcast_float_dtype(
                        *fmm.get(c, train_minmax[c]))
                    out[c] = discs[c].transform(out[c].astype(dt))
                out["train_tag"] = tag
                out.to_csv(self.preprocess_path, mode="w" if first else "a",
                           header=first, index=False)
                first = False
        assert kept_off == len(final_domain)
