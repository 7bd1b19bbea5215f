"""ModelNet40 dataset pipelines over the npz schema: a copy of
`if_defense_tpu/data/modelnet40.py` (numpy only; its package imports JAX).

Five variants mirroring `baselines/dataset/ModelNet40.py:19-174`, written as
plain indexable objects plus a host batching iterator that yields
fixed-shape numpy batches (copied to the device by the caller). No torch
DataLoader: batching and shuffling are a few lines of numpy.
"""

from __future__ import annotations

import numpy as np

from if_defense_tpu_torch.data.augment import jitter_point_cloud, rotate_point_cloud
from if_defense_tpu_torch.data.npz import load_npz


def _normalize_np(pc: np.ndarray) -> np.ndarray:
    """Unit-sphere normalisation (`pointnet_utils.normalize_points_np`)."""
    pc = pc - pc.mean(axis=0, keepdims=True)
    dist = np.max(np.sqrt((pc**2).sum(axis=1)))
    pc = pc / dist
    assert not np.isnan(pc).any(), "degenerate cloud in normalisation"
    return pc


class ModelNet40:
    """Plain classification dataset: [N, 3] cloud + label.

    Train: random resample (with replacement) to `num_points`, rotate+jitter
    augmentation. Test: first `num_points`. Unit-sphere normalised.
    """

    def __init__(
        self,
        data_root: str,
        num_points: int,
        normalize: bool = True,
        partition: str = "train",
        augmentation: bool | None = None,
        seed: int = 1,
    ):
        assert partition in ("train", "test")
        d = load_npz(data_root)
        if partition == "train":
            self.data, self.label = d.train_pc, d.train_label
        else:
            self.data, self.label = d.test_pc, d.test_label
        self.num_points = num_points
        self.normalize = normalize
        self.partition = partition
        self.augmentation = (
            (partition == "train") if augmentation is None else augmentation
        )
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, item):
        pc = np.asarray(self.data[item][:, :3], dtype=np.float32)
        if self.partition == "test":
            pc = pc[: self.num_points]
        else:
            idx = self.rng.integers(0, len(pc), size=self.num_points)
            pc = pc[idx]
        label = self.label[item]
        if self.normalize:
            pc = _normalize_np(pc)
        if self.augmentation:
            pc = rotate_point_cloud(pc, self.rng)
            pc = jitter_point_cloud(pc, self.rng)
        return pc.astype(np.float32), np.int32(label)


class ModelNet40Hybrid(ModelNet40):
    """Clean + defended data concatenated for hybrid training.

    Test mode evaluates one subset at a time (`subset='ori'|'def'`).
    """

    def __init__(
        self,
        ori_data: str,
        def_data: str,
        num_points: int,
        normalize: bool = True,
        partition: str = "train",
        augmentation: bool | None = None,
        subset: str = "ori",
        seed: int = 1,
    ):
        assert partition in ("train", "test")
        o = load_npz(ori_data)
        f = load_npz(def_data)
        if partition == "train":
            self.data = np.concatenate(
                [o.train_pc[..., :3], f.train_pc[..., :3]], axis=0
            )
            self.label = np.concatenate([o.train_label, f.train_label], axis=0)
        else:
            src = o if subset == "ori" else f
            if subset not in ("ori", "def"):
                raise ValueError(f"unknown subset {subset!r}")
            self.data = src.test_pc[..., :3]
            self.label = src.test_label
        self.rng = np.random.default_rng(seed)
        if partition == "train":
            perm = self.rng.permutation(len(self.label))
            self.data = self.data[perm]
            self.label = self.label[perm]
        self.num_points = num_points
        self.normalize = normalize
        self.partition = partition
        self.augmentation = (
            (partition == "train") if augmentation is None else augmentation
        )


class ModelNet40Normal:
    """Test clouds with point normals, [N, 6] (kNN-attack projection)."""

    def __init__(self, data_root: str, num_points: int, normalize: bool = True):
        d = load_npz(data_root)
        self.data, self.label = d.test_pc, d.test_label
        self.num_points = num_points
        self.normalize = normalize

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, item):
        pc = np.array(self.data[item][: self.num_points, :6], dtype=np.float32)
        if self.normalize:
            pc[:, :3] = _normalize_np(pc[:, :3])
        return pc, np.int32(self.label[item])


class ModelNet40Attack:
    """Test clouds + ground-truth label + attack target label."""

    def __init__(self, data_root: str, num_points: int, normalize: bool = True):
        d = load_npz(data_root)
        if d.target_label is None:
            raise ValueError(
                f"{data_root} has no 'target_label' key (required for the "
                "attack dataset variants)"
            )
        self.data, self.label, self.target = d.test_pc, d.test_label, d.target_label
        self.num_points = num_points
        self.normalize = normalize

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, item):
        pc = np.asarray(self.data[item][: self.num_points, :3], dtype=np.float32)
        if self.normalize:
            pc = _normalize_np(pc)
        return pc, np.int32(self.label[item]), np.int32(self.target[item])


class ModelNet40NormalAttack:
    """Test clouds with normals + label + target label."""

    def __init__(self, data_root: str, num_points: int, normalize: bool = True):
        d = load_npz(data_root)
        if d.target_label is None:
            raise ValueError(
                f"{data_root} has no 'target_label' key (required for the "
                "attack dataset variants)"
            )
        self.data, self.label, self.target = d.test_pc, d.test_label, d.target_label
        self.num_points = num_points
        self.normalize = normalize

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, item):
        pc = np.array(self.data[item][: self.num_points, :6], dtype=np.float32)
        if self.normalize:
            pc[:, :3] = _normalize_np(pc[:, :3])
        return pc, np.int32(self.label[item]), np.int32(self.target[item])


def batch_iterator(
    dataset,
    batch_size: int,
    shuffle: bool = False,
    drop_last: bool = False,
    pad_last: bool = False,
    seed: int = 0,
):
    """Yield stacked numpy batches from any of the dataset variants.

    `pad_last=True` repeats the final example to keep the batch shape static
    (one shape for every batch); a `valid` count is yielded alongside.

    Yields:
        (batch_tuple, valid) — batch_tuple stacks each dataset field,
        valid is the number of real (non-padded) examples.
    """
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for start in range(0, n, batch_size):
        idx = order[start : start + batch_size]
        if len(idx) < batch_size:
            if drop_last:
                return
            if pad_last:
                pad = np.full(batch_size - len(idx), idx[-1])
                idx = np.concatenate([idx, pad])
        items = [dataset[int(i)] for i in idx]
        fields = tuple(np.stack([it[f] for it in items]) for f in range(len(items[0])))
        valid = min(batch_size, n - start)
        yield fields, valid
