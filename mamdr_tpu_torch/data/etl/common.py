"""Shared ETL machinery: id remapping, negative sampling, the splits, in
numpy and the standard library.

Counterpart of ``mamdr_tpu/data/etl/common.py``, which runs the reference
dataset-builder recipe (dataset/Amazon/split.py, dataset/Taobao/split.py,
utils/tool.py:48-171) on pandas and sklearn:

  per domain: dedup -> positives = all interactions (label 1) split
  60/20/20 -> per-user negatives, n_clicked/ctr_ratio from the domain's item
  pool minus the user's clicked items, each user's negatives split 60/20/20
  -> on-disk shuffle with the seed -> domain_property.json; ctr_ratio fixed
  or drawn from ctr_ratio_range per domain.

Neither pandas nor sklearn is used, and for the same raw files and conf the
files written are byte-equal to the JAX package's. What replaces them:

- a frame is a dict of equal-length numpy columns (``Frame``), read from
  and written to CSV as pandas reads and writes it: a column whose every
  value parses as an integer is int64, else one whose values parse as
  floats (empty cells NaN) is float64, else strings; floats written as
  ``repr``, NaN empty, lines ending in ``\\n``;
- ``drop_duplicates`` and ``unique()`` keep the first occurrence, in order;
  ``groupby`` takes the sorted keys and each group's rows in order;
- sklearn's ``train_test_split`` with an int ``random_state``: unstratified,
  test = ``RandomState(seed).permutation(n)[:ceil(f * n)]`` and train the
  rest; stratified, ``StratifiedShuffleSplit``'s draws (per-class
  permutations and its ``_approximate_mode``) on the same ``RandomState``,
  in the same order (``_train_test_split``);
- ``sklearn.utils.shuffle(df, random_state=s)``: ``RandomState(s).shuffle``
  of ``arange(n)``.
"""

from __future__ import annotations

import csv
import json
import math
import os
import os.path as osp
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

HEADER = ["uid", "pid", "domain", "label"]

Frame = Dict[str, np.ndarray]  # column -> values; the dict's order is the columns'


# ---------------- frames ----------------

def _typed(values: List[str]) -> np.ndarray:
    """One CSV column as pandas' parser types it: int64, else float64 (an
    empty cell NaN), else strings."""
    try:
        return np.array([int(v) for v in values], dtype=np.int64)
    except (ValueError, OverflowError):
        pass
    try:
        return np.array([float(v) if v.strip() else np.nan for v in values], dtype=np.float64)
    except ValueError:
        return np.array(values, dtype=object)


def read_csv(path: str) -> Frame:
    """A CSV file with a header line as a frame (``pd.read_csv``)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    cols = list(zip(*body)) if body else [() for _ in header]
    return {name: (_typed(list(c)) if body else np.array([], dtype=object))
            for name, c in zip(header, cols)}


def _text(col: np.ndarray) -> List[str]:
    """A column's cells as ``DataFrame.to_csv`` writes them."""
    if col.dtype.kind in "iu":
        return [str(v) for v in col.tolist()]
    if col.dtype.kind == "f":
        return ["" if math.isnan(v) else repr(v) for v in col.tolist()]
    return [str(v) for v in col.tolist()]


def write_csv(path: str, frame: Frame, columns: Optional[Sequence[str]] = None,
              header: bool = True, mode: str = "w") -> None:
    """``frame[columns].to_csv(path, index=False, header=header, mode=mode)``."""
    columns = list(frame) if columns is None else list(columns)
    cells = [_text(frame[c]) for c in columns]
    with open(path, mode, newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        if header:
            w.writerow(columns)
        w.writerows(zip(*cells))


def n_rows(frame: Frame) -> int:
    return len(next(iter(frame.values()))) if frame else 0


def take(frame: Frame, idx) -> Frame:
    idx = np.asarray(idx, dtype=np.int64)
    return {k: v[idx] for k, v in frame.items()}


def first_occurrences(frame: Frame, columns: Optional[Sequence[str]] = None) -> np.ndarray:
    """Row indices of ``drop_duplicates(subset=columns)``: each distinct row's
    first occurrence, in order."""
    cols = [frame[c] for c in (list(frame) if columns is None else columns)]
    n = n_rows(frame)
    if n == 0:
        return np.zeros(0, np.int64)
    if all(c.dtype.kind in "iu" for c in cols):
        _, idx = np.unique(np.stack(cols, axis=1), axis=0, return_index=True)
        return np.sort(idx)
    seen, keep = set(), []
    for i, key in enumerate(zip(*(c.tolist() for c in cols))):
        if key not in seen:
            seen.add(key)
            keep.append(i)
    return np.asarray(keep, dtype=np.int64)


def unique_in_order(col: np.ndarray) -> np.ndarray:
    """``Series.unique()``: the distinct values in order of first occurrence."""
    return col[first_occurrences({"c": col})]


def group_rows(keys: np.ndarray) -> List[Tuple[object, np.ndarray]]:
    """``groupby(keys)``: (key, its rows in order) for each key, keys sorted."""
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    starts = np.flatnonzero(np.r_[True, sorted_keys[1:] != sorted_keys[:-1]]) if len(keys) else []
    ends = list(starts[1:]) + [len(keys)]
    return [(sorted_keys[s], order[s:e]) for s, e in zip(starts, ends)]


# ---------------- sklearn's splits ----------------

def _check_random_state(seed):
    if seed is None:
        return np.random.mtrand._rand
    if isinstance(seed, np.random.RandomState):
        return seed
    return np.random.RandomState(seed)


def _validate_shuffle_split(n: int, test_size) -> Tuple[int, int]:
    """(n_train, n_test) for a float or int ``test_size`` and no train size
    (sklearn ``_validate_shuffle_split``)."""
    is_int = isinstance(test_size, (int, np.integer))
    if (is_int and (test_size >= n or test_size <= 0)) or (
            not is_int and (test_size <= 0 or test_size >= 1)):
        raise ValueError(f"test_size={test_size} should be either positive and smaller than "
                         f"the number of samples {n} or a float in the (0, 1) range")
    n_test = int(test_size) if is_int else math.ceil(test_size * n)
    n_train = n - n_test
    if n_train == 0:
        raise ValueError(f"With n_samples={n}, test_size={test_size} and train_size=None, the "
                         "resulting train set will be empty. Adjust any of the aforementioned "
                         "parameters.")
    return n_train, n_test


def _approximate_mode(class_counts: np.ndarray, n_draws: int, rng) -> np.ndarray:
    """sklearn ``utils.extmath._approximate_mode``: the per-class draws, ties
    broken with ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _train_test_split(n: int, test_size, random_state,
                      stratify: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(train rows, test rows) of sklearn's ``train_test_split`` on ``n``
    rows: a ``ShuffleSplit``, or with ``stratify`` (one label a row) a
    ``StratifiedShuffleSplit``, each drawing from ``random_state``."""
    n_train, n_test = _validate_shuffle_split(n, test_size)
    if stratify is None:
        perm = _check_random_state(random_state).permutation(n)
        return perm[n_test:n_test + n_train], perm[:n_test]
    _validate_shuffle_split(n, n_test)
    y = np.asarray(stratify).astype(str)  # sklearn's string form of a 2-D y's rows
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    n_classes = classes.shape[0]
    if np.min(class_counts) < 2:
        raise ValueError("The least populated classes in y have only 1 member, which is too "
                         "few. The minimum number of groups for any class cannot be less than "
                         f"2. Classes with too few members are: "
                         f"{classes[class_counts < 2].tolist()}")
    if n_train < n_classes:
        raise ValueError(f"The train_size = {n_train} should be greater or equal to the "
                         f"number of classes = {n_classes}")
    if n_test < n_classes:
        raise ValueError(f"The test_size = {n_test} should be greater or equal to the "
                         f"number of classes = {n_classes}")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = _check_random_state(random_state)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train: List[int] = []
    test: List[int] = []
    for i in range(n_classes):
        perm_i = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm_i[: n_i[i]])
        test.extend(perm_i[n_i[i]: n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


# ---------------- the recipe ----------------

class RawId2Id:
    """Persistent string->int id map shared across domains
    (reference utils/tool.py:48-95), with content-hash-guarded export."""

    def __init__(self, path: str = "", rebuild: bool = False):
        self.raw_id2id: Dict[str, int] = {}
        self.id = 0
        if path and osp.exists(path) and not rebuild:
            self.load(path)

    def content_hash(self) -> int:
        return hash(json.dumps({"id": self.id, "raw_id2id": self.raw_id2id}))

    def fit_transform(self, x) -> int:
        x = str(x)
        if x in self.raw_id2id:
            return self.raw_id2id[x]
        self.raw_id2id[x] = self.id
        self.id += 1
        return self.id - 1

    def export(self, path: str) -> None:
        os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"id": self.id, "raw_id2id": self.raw_id2id}, f)

    def load(self, path: str) -> None:
        with open(path) as f:
            d = json.load(f)
        self.id = d["id"]
        self.raw_id2id = d["raw_id2id"]


def split_stratified_into_train_val_test(
    df: Frame,
    stratify_colname: str = "label",
    frac_train: float = 0.6,
    frac_val: float = 0.2,
    frac_test: float = 0.2,
    random_state=None,
) -> Tuple[Frame, Frame, Frame]:
    """Two-stage split (reference utils/tool.py:96-159), stratified on
    ``stratify_colname`` when it holds more than one value."""
    if abs(frac_train + frac_val + frac_test - 1.0) > 1e-9:
        raise ValueError(
            f"fractions {frac_train}, {frac_val}, {frac_test} do not add up to 1.0")
    if stratify_colname not in df:
        raise ValueError(f"{stratify_colname} is not a column in the dataframe")
    y = df[stratify_colname]
    stratify = y if len(unique_in_order(y)) > 1 else None
    tr, temp = _train_test_split(n_rows(df), 1.0 - frac_train, random_state, stratify)
    df_train, df_temp = take(df, tr), take(df, temp)
    if len(temp) > 1:
        rel_test = frac_test / (frac_val + frac_test)
        y_temp = y[temp]
        strat2 = y_temp if stratify is not None and len(unique_in_order(y_temp)) > 1 else None
        va, te = _train_test_split(len(temp), rel_test, random_state, strat2)
        return df_train, take(df_temp, va), take(df_temp, te)
    return df_train, take(df_temp, []), df_temp


def shuffle_csv_file(filename: str, seed: int = 123) -> None:
    """Rewrite a CSV file with its rows in the order of
    ``RandomState(seed).shuffle`` (sklearn ``shuffle``, then ``to_csv``)."""
    df = read_csv(filename)
    idx = np.arange(n_rows(df))
    np.random.RandomState(seed).shuffle(idx)
    write_csv(filename, take(df, idx))


def _negatives_frame(uid: np.ndarray, pid: np.ndarray, domain: int) -> Frame:
    uid, pid = np.asarray(uid, np.int64), np.asarray(pid, np.int64)
    return {"uid": uid, "pid": pid, "domain": np.full(len(uid), domain, np.int64),
            "label": np.zeros(len(uid), np.int64)}


def sample_negatives_for_domain(
    df: Frame,
    pid_range: Sequence[int],
    ctr_ratio: float,
    domain: int,
    rng: random.Random,
) -> Frame:
    """Per-user negatives: n_clicked/ctr_ratio items drawn without
    replacement from the domain pool minus the user's clicked items
    (reference split.py:46-70), one ``rng.sample`` a user in sorted uid
    order."""
    pool = np.asarray(sorted(set(int(p) for p in pid_range)))
    uids, pids = [], []
    for uid, rows in group_rows(df["uid"]):
        clicked = set(int(p) for p in unique_in_order(df["pid"][rows]))
        negative_num = int(len(rows) / ctr_ratio)
        candidates = pool[~np.isin(pool, list(clicked))]
        if negative_num >= len(candidates):
            sampled = candidates
        else:
            idx = rng.sample(range(len(candidates)), negative_num)
            sampled = candidates[np.asarray(idx, dtype=np.int64)]
        if len(sampled) == 0:
            continue
        uids.append(np.full(len(sampled), int(uid), np.int64))
        pids.append(sampled)
    if not uids:
        return _negatives_frame(np.zeros(0), np.zeros(0), domain)
    return _negatives_frame(np.concatenate(uids), np.concatenate(pids), domain)


def _complement_map(clicked_uid_ord, clicked_dense, n_users, pool_size):
    """Per-user complement mapping state. For user u with sorted clicked
    dense positions s_0<...<s_{c-1} in [0, pool_size), the k-th element of
    the complement (pool minus clicked, ascending) is k + |{i : s_i - i <= k}|
    — one searchsorted over the user-offset adjusted positions answers that
    count for every (u, k) draw at once. Inputs sorted by (uid_ord, dense)."""
    counts = np.bincount(clicked_uid_ord, minlength=n_users)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(clicked_uid_ord.shape[0]) - starts[clicked_uid_ord]
    adj = clicked_dense - within
    comb_adj = clicked_uid_ord.astype(np.int64) * (pool_size + 1) + adj
    return comb_adj, starts, counts


def _map_complement(draw_uid_ord, draw_k, comb_adj, starts, pool_size):
    """(user, complement-index) -> dense pool position, vectorised."""
    keys = draw_uid_ord.astype(np.int64) * (pool_size + 1) + draw_k
    cnt = np.searchsorted(comb_adj, keys, side="right") - starts[draw_uid_ord]
    return draw_k + cnt


def sample_negatives_vectorized(
    df: Frame,
    pid_range: Sequence[int],
    ctr_ratio: float,
    domain: int,
    np_rng: np.random.Generator,
) -> Frame:
    """Per-user negative sampling in flat numpy passes, the recipe of
    ``sample_negatives_for_domain``: each user gets floor(n_clicked /
    ctr_ratio) items without replacement from the domain pool minus their
    clicked items (the whole complement when the quota exceeds it). One
    searchsorted maps complement indices to pool positions for every user at
    once; dense users (quota >= 4/5 of the complement) take a random-key
    sort of their complement, the rest iterated dedup-and-redraw. The draws
    from ``np_rng`` are the JAX package's, in the same order."""
    pool = np.unique(np.asarray(list(pid_range), dtype=np.int64))
    p_size = pool.shape[0]

    pairs = take(df, first_occurrences(df, ["uid", "pid"]))
    uids = pairs["uid"]
    uniq_uids, uid_ord = np.unique(uids, return_inverse=True)
    n_users = uniq_uids.shape[0]
    dense = np.searchsorted(pool, pairs["pid"].astype(np.int64))
    order = np.lexsort((dense, uid_ord))
    uid_ord_s, dense_s = uid_ord[order], dense[order]
    comb_adj, starts, clicked_counts = _complement_map(uid_ord_s, dense_s, n_users, p_size)

    quota = (clicked_counts / ctr_ratio).astype(np.int64)
    comp_size = p_size - clicked_counts
    quota = np.minimum(quota, comp_size)
    enum_users = np.nonzero((quota > 0) & (quota * 5 >= comp_size * 4))[0]
    samp_users = np.nonzero((quota > 0) & (quota * 5 < comp_size * 4))[0]

    out_uid_ord, out_dense = [], []
    if enum_users.size:
        ks = np.concatenate([np.arange(comp_size[u]) for u in enum_users])
        us = np.repeat(enum_users, comp_size[enum_users])
        mapped = _map_complement(us, ks, comb_adj, starts, p_size)
        keys = np_rng.random(mapped.shape[0])
        o = np.lexsort((keys, us))
        us, mapped = us[o], mapped[o]
        cstarts = np.concatenate([[0], np.cumsum(comp_size[enum_users])[:-1]])
        pos_in_user = np.arange(us.shape[0]) - np.repeat(cstarts, comp_size[enum_users])
        keep = pos_in_user < np.repeat(quota[enum_users], comp_size[enum_users])
        out_uid_ord.append(us[keep])
        out_dense.append(mapped[keep])
    if samp_users.size:
        chosen_keys = np.empty(0, np.int64)
        deficit = quota[samp_users].copy()
        for _ in range(200):
            short = deficit > 0
            if not short.any():
                break
            us = np.repeat(samp_users[short], deficit[short])
            ks = np.floor(np_rng.random(us.shape[0]) * comp_size[us]).astype(np.int64)
            mapped = _map_complement(us, ks, comb_adj, starts, p_size)
            new_keys = us.astype(np.int64) * p_size + mapped
            chosen_keys = np.unique(np.concatenate([chosen_keys, new_keys]))
            have = np.bincount(chosen_keys // p_size, minlength=n_users)[samp_users]
            deficit = quota[samp_users] - have
        out_uid_ord.append((chosen_keys // p_size).astype(np.int64))
        out_dense.append(chosen_keys % p_size)
    if not out_uid_ord:
        return _negatives_frame(np.zeros(0), np.zeros(0), domain)
    return _negatives_frame(uniq_uids[np.concatenate(out_uid_ord)],
                            pool[np.concatenate(out_dense)], domain)


def assign_user_splits(uid: np.ndarray, fracs: Sequence[float],
                       np_rng: np.random.Generator) -> np.ndarray:
    """Per-user train/val/test assignment (0/1/2) of each user's rows, by the
    arithmetic of the reference's per-user two-stage split: with m rows,
    n_temp = ceil(m * (1 - f_train)) leave train, of which
    n_test = ceil(n_temp * f_test / (f_val + f_test)) go to test; m == 2
    gives 1 train + 1 test, m == 1 train only. Which rows land where is a
    uniform per-user permutation from ``np_rng``."""
    f_train, f_val, f_test = fracs
    n = uid.shape[0]
    _, ord_ = np.unique(uid, return_inverse=True)
    m = np.bincount(ord_)
    keys = np_rng.random(n)
    o = np.lexsort((keys, ord_))
    starts = np.concatenate([[0], np.cumsum(m)[:-1]])
    pos = np.empty(n, np.int64)
    pos[o] = np.arange(n) - starts[ord_[o]]
    m_row = m[ord_]
    n_temp = np.ceil(m_row * (1.0 - f_train)).astype(np.int64)
    n_tr = m_row - n_temp
    n_te = np.ceil(n_temp * (f_test / (f_val + f_test))).astype(np.int64)
    out = np.full(n, 2, np.int8)
    out[pos < n_tr + (n_temp - n_te)] = 1
    out[pos < n_tr] = 0
    out[m_row < 2] = 0
    return out


def _append_rows(path: str, frame: Frame) -> None:
    """Append ``frame[HEADER]``'s rows through ``csv.writer`` (``\\r\\n``)."""
    with open(path, "a", newline="") as f:
        csv.writer(f).writerows(zip(*(_text(frame[c]) for c in HEADER)))


def _write_header(domain_save_path: str) -> None:
    for name in ("train.csv", "val.csv", "test.csv"):
        with open(osp.join(domain_save_path, name), "w", newline="") as f:
            csv.writer(f).writerow(HEADER)


def _append_split(domain_save_path: str, df: Frame, conf: dict) -> None:
    """A frame's 60/20/20 split appended to the domain's three files; a
    single-row frame goes to train whole (the split would leave train
    empty, where sklearn raises)."""
    if n_rows(df) < 2:
        _append_rows(osp.join(domain_save_path, "train.csv"), df)
        return
    tr, va, te = split_stratified_into_train_val_test(
        df, stratify_colname="label", frac_train=conf["train_val_test"][0],
        frac_val=conf["train_val_test"][1], frac_test=conf["train_val_test"][2],
        random_state=conf["seed"])
    for name, part in (("train.csv", tr), ("val.csv", va), ("test.csv", te)):
        _append_rows(osp.join(domain_save_path, name), part)


def split_domains(processed_file_list: List[str], split_save_path: str, conf: dict,
                  rename_cols: Optional[Dict[str, str]] = None) -> int:
    """The domain split driver shared by Amazon (by category) and Taobao (by
    theme) — reference split.py:93-152 / Taobao split.py:94-152; JAX
    ``split_domains``, the same draws in the same order. Per processed file:
    the positives' split, the per-user negatives (vectorised, or with
    ``conf["legacy_negatives"]`` the per-user loop, each user's negatives
    split on their own), ``domain_property.json``, and the seeded on-disk
    shuffle, which re-runs on every invocation, also for domains already
    built (reference split.py:148-149 sits outside the rebuild branch)."""
    rng = random.Random(conf["seed"])
    np_rng = np.random.default_rng(conf["seed"])
    n_domain = 0
    for p in processed_file_list:
        domain_name = osp.splitext(osp.split(p)[1])[0]
        domain_save_path = osp.join(split_save_path, f"domain_{n_domain}")
        exists = osp.exists(osp.join(domain_save_path, "train.csv"))
        if not exists or conf.get("rebuild", False):
            os.makedirs(domain_save_path, exist_ok=True)
            _write_header(domain_save_path)
            if conf.get("random_range"):
                ctr_ratio = round(rng.uniform(*conf["ctr_ratio_range"]), 2)
            else:
                ctr_ratio = conf["ctr_ratio"]

            df = read_csv(p)
            if rename_cols:
                df = {rename_cols.get(k, k): v for k, v in df.items()}
            df = take(df, first_occurrences(df))
            pid_range = unique_in_order(df["pid"]).tolist()
            n_uid = len(unique_in_order(df["uid"]))
            n_pid = len(pid_range)
            df["domain"] = np.full(n_rows(df), n_domain, np.int64)
            positive_df = dict(df, label=np.ones(n_rows(df), np.int64))
            _append_split(domain_save_path, positive_df, conf)

            if conf.get("legacy_negatives", False):
                negatives = sample_negatives_for_domain(df, pid_range, ctr_ratio, n_domain, rng)
                for _, rows in group_rows(negatives["uid"]):
                    _append_split(domain_save_path, take(negatives, rows), conf)
            else:
                negatives = sample_negatives_vectorized(df, pid_range, ctr_ratio, n_domain,
                                                        np_rng)
                assign = assign_user_splits(negatives["uid"], conf["train_val_test"], np_rng)
                for code, name in ((0, "train.csv"), (1, "val.csv"), (2, "test.csv")):
                    part = take(negatives, np.flatnonzero(assign == code))
                    if n_rows(part):
                        write_csv(osp.join(domain_save_path, name), part, HEADER,
                                  header=False, mode="a")

            with open(osp.join(domain_save_path, "domain_property.json"), "w") as f:
                json.dump({"domain_name": domain_name, "n_uid": int(n_uid),
                           "n_pid": int(n_pid), "ctr_ratio": ctr_ratio,
                           "pid_range": [int(x) for x in pid_range]}, f)
        for name in ("train.csv", "val.csv", "test.csv"):
            shuffle_csv_file(osp.join(domain_save_path, name), conf["seed"])
        n_domain += 1
    return n_domain
