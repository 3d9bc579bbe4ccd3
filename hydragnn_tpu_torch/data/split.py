"""Dataset splitting (port of ``data/split.py``): the stratified
train/validation/test split that keeps each element-composition category
on both sides, and the plain proportional split.

The JAX package draws the stratified split with scikit-learn's
``StratifiedShuffleSplit(n_splits=1, train_size=..., random_state=0)``.
:func:`stratified_shuffle_split` is that algorithm in numpy (scikit-learn
1.9.0's ``_iter_indices`` and ``_approximate_mode``): the per-class train
and test counts from ``RandomState(0)``'s tie breaks, a permutation of
each class's members, then a permutation of the train and of the test
indices, all drawn from the one ``RandomState`` in that order. It gives
the same indices as scikit-learn for the same categories.
"""

import collections
import math
from typing import List, Sequence, Tuple

import numpy as np


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """Per-class draws near the mode of the multivariate hypergeometric:
    the floors of the proportional shares, then one more for the classes
    with the largest remainders, ties broken by ``rng``."""
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


def stratified_shuffle_split(y: Sequence, train_size: float,
                             random_state: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """``(train, test)`` indices of one stratified shuffle split of the
    labels ``y`` with a float ``train_size`` in (0, 1) (the test side takes
    the rest)."""
    y = np.asarray(y)
    n_samples = y.shape[0]
    if not 0 < train_size < 1:
        raise ValueError(f"train_size={train_size} should be a float in the (0, 1) range")
    n_train = math.floor(train_size * n_samples)
    n_test = n_samples - n_train
    if n_train == 0:
        raise ValueError(f"With n_samples={n_samples} and train_size={train_size}, the "
                         "train set would be empty")
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    if np.min(class_counts) < 2:
        raise ValueError("The least populated classes in y have only 1 member, which is "
                         f"too few: {classes[class_counts < 2].tolist()}")
    if n_train < classes.shape[0] or n_test < classes.shape[0]:
        raise ValueError(f"train ({n_train}) and test ({n_test}) sizes must each be at "
                         f"least the number of classes ({classes.shape[0]})")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(random_state)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(classes.shape[0]):
        members = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(members[: n_i[i]])
        test.extend(members[n_i[i] : n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def _dataset_categories(dataset) -> List[int]:
    """Each graph's element composition as one integer category."""
    max_graph_size = max(d.num_nodes for d in dataset)
    power_ten = math.ceil(math.log10(max(max_graph_size, 2)))
    elements = sorted(set(float(e) for d in dataset for e in np.unique(d.x[:, 0])))
    element_index = {e: i for i, e in enumerate(elements)}
    categories = []
    for d in dataset:
        vals, counts = np.unique(d.x[:, 0], return_counts=True)
        categories.append(sum(int(c) * (10 ** (power_ten * element_index[float(v)]))
                              for v, c in zip(vals, counts)))
    return categories


def _duplicate_singletons(dataset, categories):
    """A copy of each sample alone in its category, so that the split can
    put one on each side."""
    counter = collections.Counter(categories)
    extra = [(d.clone(), c) for d, c in zip(dataset, categories) if counter[c] == 1]
    return list(dataset) + [d for d, _ in extra], list(categories) + [c for _, c in extra]


def _partition(dataset, categories, train_size):
    idx_a, idx_b = stratified_shuffle_split(categories, train_size, random_state=0)
    return [dataset[i] for i in idx_a], [dataset[i] for i in idx_b]


def compositional_stratified_splitting(dataset, perc_train: float):
    categories = _dataset_categories(dataset)
    dataset, categories = _duplicate_singletons(dataset, categories)
    trainset, val_test = _partition(dataset, categories, perc_train)
    vt_categories = _dataset_categories(val_test)
    val_test, vt_categories = _duplicate_singletons(val_test, vt_categories)
    valset, testset = _partition(val_test, vt_categories, 0.5)
    return trainset, valset, testset


def split_dataset(dataset, perc_train: float, stratify_splitting: bool):
    if not stratify_splitting:
        perc_val = (1 - perc_train) / 2
        n = len(dataset)
        a, b = int(n * perc_train), int(n * (perc_train + perc_val))
        return dataset[:a], dataset[a:b], dataset[b:]
    return compositional_stratified_splitting(dataset, perc_train)


def stratified_subsample(dataset, subsample_percentage: float):
    """A stratified subsample; the category is the sorted per-type count
    signature in base 100."""
    categories = []
    for d in dataset:
        freqs = sorted(int(f) for f in np.bincount(d.x[:, 0].astype(np.int64)) if f > 0)
        categories.append(sum(f * (100 ** i) for i, f in enumerate(freqs)))
    idx, _ = stratified_shuffle_split(categories, subsample_percentage, random_state=0)
    return [dataset[i] for i in idx]
