"""Train ingestion configuration (the port of
ray_tpu/train/data_config.py; duck-typed: a ray_tpu_torch.data Dataset,
or anything with `streaming_split`, is split, every other object is
broadcast).

Analog of the reference's DataConfig
(python/ray/train/_internal/data_config.py): decides which datasets are
split across training workers (streaming_split: one shared per-epoch
streaming execution dealt to n worker iterators) and which are
broadcast whole to every worker.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union


class DataConfig:
    def __init__(self,
                 datasets_to_split: Union[str, List[str]] = "all",
                 prefetch_blocks: Optional[int] = None):
        """prefetch_blocks: blocks each worker's DataIterator requests
        from the split coordinator (and pulls to its node) ahead of
        consumption; None uses config.data_iterator_prefetch_blocks."""
        if datasets_to_split != "all" and not isinstance(
                datasets_to_split, (list, tuple, set)):
            raise TypeError(
                "datasets_to_split must be 'all' or a list of dataset names"
            )
        self._datasets_to_split = datasets_to_split
        self._prefetch_blocks = prefetch_blocks

    def _should_split(self, name: str) -> bool:
        if self._datasets_to_split == "all":
            return True
        return name in self._datasets_to_split

    def configure(self, datasets: Dict[str, Any],
                  num_workers: int) -> List[Dict[str, Any]]:
        """Per-worker {name: DataIterator|Dataset} dicts. Split datasets
        hand worker i split i of a streaming_split(num_workers,
        equal=True); the rest are broadcast as-is."""
        per_worker: List[Dict[str, Any]] = [{} for _ in range(num_workers)]
        for name, ds in (datasets or {}).items():
            if (self._should_split(name)
                    and hasattr(ds, "streaming_split")
                    and num_workers >= 1):
                splits = ds.streaming_split(
                    num_workers, equal=True,
                    prefetch_blocks=self._prefetch_blocks,
                )
                for i in range(num_workers):
                    per_worker[i][name] = splits[i]
            else:
                for i in range(num_workers):
                    per_worker[i][name] = ds
        return per_worker
