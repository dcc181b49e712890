"""Train/val/test splitting of a table's rows, optionally stratified.

Counterpart of `matten_tpu/data/split.py` without sklearn or pandas: the
rows are `read_table`'s list of row dicts (or any object with `iloc`, such
as a DataFrame, which gets `df.iloc[...]` back). For the same seed the
splits hold the same rows in the same order as the JAX functions, which
call sklearn's `train_test_split`: its `ShuffleSplit` (one
`RandomState(seed).permutation`; the test rows first) and its
`StratifiedShuffleSplit` (per-class counts by `_approximate_mode`, one
permutation per class, then one of each split), restated here with the
same random draws in the same order.
"""

from __future__ import annotations

from math import ceil
from numbers import Integral
from typing import Optional, Tuple

import numpy as np

__all__ = ["train_test_split_dataframe", "train_val_test_split_dataframe"]


def _counts(n: int, test_size) -> Tuple[int, int]:
    """(n_train, n_test) of `test_size`, a fraction in (0, 1) or a count in
    [1, n), as sklearn's `_validate_shuffle_split`."""
    if isinstance(test_size, Integral):
        if not 0 < test_size < n:
            raise ValueError(f"test_size={test_size} should be a count in (0, {n})")
        n_test = int(test_size)
    else:
        if not 0 < test_size < 1:
            raise ValueError(f"test_size={test_size} should be a float in the (0, 1) range")
        n_test = ceil(test_size * n)
    n_train = n - n_test
    if n_train == 0:
        raise ValueError(
            f"With n_samples={n} and test_size={test_size} the train set would be empty")
    return n_train, n_test


def _approximate_mode(class_counts: np.ndarray, n_draws: int, rng: np.random.RandomState) -> np.ndarray:
    """Per-class draws closest to the proportions, remainders handed out
    largest first with ties broken by `rng` (sklearn's `_approximate_mode`)."""
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


def _stratified(y: np.ndarray, n_train: int, n_test: int,
                rng: np.random.RandomState) -> Tuple[np.ndarray, np.ndarray]:
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    if class_counts.min() < 2:
        raise ValueError(
            "The least populated classes in y have only 1 member, which is too few. "
            f"Classes with too few members are: {classes[class_counts < 2].tolist()}")
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(
            f"train ({n_train}) and test ({n_test}) sizes must be at least the number of "
            f"classes ({len(classes)})")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        members = class_indices[i][rng.permutation(class_counts[i])]
        train.extend(members[: n_i[i]])
        test.extend(members[n_i[i] : n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def _column(df, name: str) -> np.ndarray:
    if hasattr(df, "iloc"):
        return np.asarray(df[name])
    return np.asarray([row[name] for row in df])


def _take(df, idx: np.ndarray):
    if hasattr(df, "iloc"):
        return df.iloc[idx]
    return [df[int(i)] for i in idx]


def train_test_split_dataframe(
    df,
    test_size: float = 0.2,
    stratify: Optional[str] = None,
    random_seed: Optional[int] = 35,
):
    """(train, test) rows of `df`, shuffled by `random_seed` (None: numpy's
    global random state), optionally keeping the proportions of the
    `stratify` column in both."""
    n = len(df)
    n_train, n_test = _counts(n, test_size)
    rng = np.random.mtrand._rand if random_seed is None else np.random.RandomState(random_seed)
    if stratify is None:
        perm = rng.permutation(n)
        train, test = perm[n_test:], perm[:n_test]
    else:
        train, test = _stratified(_column(df, stratify), n_train, n_test, rng)
    return _take(df, train), _take(df, test)


def train_val_test_split_dataframe(
    df,
    val_size: float = 0.1,
    test_size: float = 0.1,
    stratify: Optional[str] = None,
    random_seed: Optional[int] = 35,
) -> Tuple:
    train_val, test = train_test_split_dataframe(
        df, test_size=test_size, stratify=stratify, random_seed=random_seed
    )
    val_fraction = val_size / (1.0 - test_size)
    train, val = train_test_split_dataframe(
        train_val, test_size=val_fraction, stratify=stratify, random_seed=random_seed
    )
    return train, val, test
