"""DataModule: config → train/val/test DataLoaders.

The port's copy of `sgdm_tpu/data/datamodule.py DataModuleFromConfig`:
datasets instantiated from ``target:`` / ``params:`` sub-configs,
``drop_last=True`` everywhere, shuffle train only, one batch size for every
split.  ``batch_size`` is the global batch: across ranks each loader gives
this rank its slice of every global batch (`_process_shard`), so the ranks
together see the batches one process sees.
"""

from __future__ import annotations

from typing import Any, Mapping

from ..config.engine import instantiate_from_config, to_container
from ..parallel.mesh import data_coords, local_batch_slice
from .loader import DataLoader

__all__ = ["DataModuleFromConfig"]


def _process_shard(batch_size: int) -> slice | None:
    """This rank's slice of every global batch on the data axis (the
    reference's per-rank DataLoader split); None in one process.  Raises
    when the batch does not split over the data axis."""
    if data_coords()[1] == 1:
        return None
    return local_batch_slice(batch_size)


class DataModuleFromConfig:
    def __init__(
        self,
        batch_size: int,
        train: Mapping[str, Any] | None = None,
        validation: Mapping[str, Any] | None = None,
        test: Mapping[str, Any] | None = None,
        num_workers: int | None = None,
        seed: int = 23,
        **_unused: Any,
    ):
        self.batch_size = batch_size
        self.num_workers = num_workers if num_workers is not None else 8
        self.seed = seed
        self._cfgs = {"train": train, "validation": validation, "test": test}
        self.datasets: dict[str, Any] = {}

    def setup(self) -> None:
        for split, cfg in self._cfgs.items():
            if cfg is not None:
                self.datasets[split] = instantiate_from_config(to_container(cfg))

    def _loader(self, split: str, shuffle: bool) -> DataLoader:
        if split not in self.datasets:
            if self._cfgs.get(split) is None:
                # no config for this split: raise without re-running setup(),
                # which would re-instantiate every configured dataset
                raise KeyError(f"no dataset configured for split {split!r}")
            self.setup()
        return DataLoader(
            self.datasets[split],
            batch_size=self.batch_size,
            shuffle=shuffle,
            drop_last=True,
            num_workers=self.num_workers,
            seed=self.seed,
            shard=_process_shard(self.batch_size),
        )

    def train_dataloader(self) -> DataLoader:
        return self._loader("train", shuffle=True)

    def val_dataloader(self) -> DataLoader:
        return self._loader("validation", shuffle=False)

    def test_dataloader(self) -> DataLoader:
        return self._loader("test", shuffle=False)
