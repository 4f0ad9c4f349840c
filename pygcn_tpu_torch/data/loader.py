"""Minibatch loaders over in-memory arrays.

The port of ``pygcn_tpu/data/loader.py`` (the reference's
``torch.utils.data`` stack, ``pygcn/utils.py:423-456``): the same NumPy
calls, so both packages give the same batches for one seed. A shuffled train
loader, ordered val/test loaders, ``quicktest`` shrinking (batch 2, 4 train
batches), and a k-fold mode that returns train+val with the test loader.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


class ArrayLoader:
    """Iterates (x_batch, y_batch) over aligned leading axes."""

    def __init__(self, arrays, batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False):
        self.arrays = [np.asarray(a) for a in arrays]
        n = self.arrays[0].shape[0]
        if any(a.shape[0] != n for a in self.arrays):
            raise ValueError(f"arrays differ in length: {[a.shape[0] for a in self.arrays]}")
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        order = np.arange(self.n)
        if self.shuffle:
            self._rng.shuffle(order)
        stop = (self.n // self.batch_size) * self.batch_size if self.drop_last else self.n
        for start in range(0, stop, self.batch_size):
            idx = order[start: start + self.batch_size]
            yield tuple(a[idx] for a in self.arrays)


def make_split_loaders(
    node_feats: np.ndarray,
    graph_labels: np.ndarray,
    idx_train,
    idx_val,
    idx_test,
    batch_size: int,
    kfold: bool = False,
    quicktest: bool = False,
    seed: int = 0,
):
    """Split loaders with the reference's quicktest/kfold behaviour
    (``pygcn/utils.py:423-456``)."""
    idx_train, idx_val, idx_test = (np.asarray(i) for i in (idx_train, idx_val, idx_test))
    if quicktest:
        batch_size = 2
        idx_train = idx_train[: batch_size * 4]
        idx_val = idx_val[:batch_size]
        idx_test = idx_test[:batch_size]

    def subset(idx):
        return node_feats[idx], graph_labels[idx]

    if kfold:
        tv = np.concatenate([idx_train, idx_val])
        train_val = subset(tv)
        test_loader = ArrayLoader(subset(idx_test), batch_size, shuffle=False)
        return train_val, test_loader

    train_loader = ArrayLoader(subset(idx_train), batch_size, shuffle=True, seed=seed)
    val_loader = ArrayLoader(subset(idx_val), batch_size, shuffle=False)
    test_loader = ArrayLoader(subset(idx_test), batch_size, shuffle=False)
    return train_loader, val_loader, test_loader


def kfold_splits(n: int, k: int, seed: int = 0):
    """Yield (train_idx, val_idx) pairs for k-fold cross-validation (the
    reference's commented-out scaffold at ``pygcn/gnn-over-mlp.py:434-480``)."""
    order = np.random.default_rng(seed).permutation(n)
    folds = np.array_split(order, k)
    for i in range(k):
        val = folds[i]
        train = np.concatenate([folds[j] for j in range(k) if j != i])
        yield train, val
