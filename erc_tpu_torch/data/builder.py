"""Declarative dataset builder (reference: lumo/data/builder.py:73-298).

Port of ``erc_tpu.data.builder``: pure Python, a copy with the same
behaviour.

Named input sources + output keys + per-input/per-output/global transforms,
chain/zip modes, and pseudo-sizing (subset/repeat/scale_to_size).  The
reference wraps torch Dataset; here it is a plain indexable over host
sample dicts feeding DialogueLoader/ERCBatcher.

    ds = (DatasetBuilder()
          .add_input('all', samples)
          .add_output('all', 'all')
          .add_output_transform('all', Missing())
          .chain())
    ds[3] -> transformed sample
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional


class DatasetBuilder:
    def __init__(self):
        self._inputs: Dict[str, List] = {}
        self._outputs: List[tuple] = []  # (input_name, output_name)
        self._input_transforms: Dict[str, List[Callable]] = {}
        self._output_transforms: Dict[str, List[Callable]] = {}
        self._global_transforms: List[Callable] = []
        self._mode = "chain"
        self._indices: Optional[List[int]] = None
        self._pseudo_size: Optional[int] = None
        self._repeats: int = 1

    # -- declaration ---------------------------------------------------------
    def add_input(self, name: str, source: List) -> "DatasetBuilder":
        self._inputs[name] = source
        return self

    def add_output(self, input_name: str, output_name: str) -> "DatasetBuilder":
        assert input_name in self._inputs, input_name
        self._outputs.append((input_name, output_name))
        return self

    def add_input_transform(self, name: str, fn: Callable) -> "DatasetBuilder":
        self._input_transforms.setdefault(name, []).append(fn)
        return self

    def add_output_transform(self, name: str, fn: Callable) -> "DatasetBuilder":
        self._output_transforms.setdefault(name, []).append(fn)
        return self

    def add_global_transform(self, fn: Callable) -> "DatasetBuilder":
        self._global_transforms.append(fn)
        return self

    def chain(self) -> "DatasetBuilder":
        """Single output → the value itself (builder.py chain mode)."""
        self._mode = "chain"
        return self

    def zip(self) -> "DatasetBuilder":
        """Dict of output_name → value."""
        self._mode = "zip"
        return self

    # -- pseudo-sizing -------------------------------------------------------
    def subset(self, indices: List[int]) -> "DatasetBuilder":
        self._indices = list(indices)
        return self

    def repeat(self, n: int) -> "DatasetBuilder":
        self._repeats = n
        return self

    def scale_to_size(self, size: int) -> "DatasetBuilder":
        self._pseudo_size = size
        return self

    # -- access --------------------------------------------------------------
    def _base_len(self) -> int:
        n = min(len(v) for v in self._inputs.values()) if self._inputs else 0
        if self._indices is not None:
            n = len(self._indices)
        return n

    def __len__(self) -> int:
        if self._pseudo_size is not None:
            return self._pseudo_size
        return self._base_len() * self._repeats

    def map_index(self, idx: int) -> int:
        base = self._base_len()
        idx = idx % max(base, 1)
        if self._indices is not None:
            idx = self._indices[idx]
        return idx

    def __getitem__(self, idx: int) -> Any:
        real = self.map_index(idx)
        outs: Dict[str, Any] = {}
        for input_name, output_name in (self._outputs or [(k, k) for k in self._inputs]):
            v = self._inputs[input_name][real]
            for fn in self._input_transforms.get(input_name, []):
                v = fn(v)
            for fn in self._output_transforms.get(output_name, []):
                v = fn(v)
            outs[output_name] = v
        if self._mode == "chain" and len(outs) == 1:
            result = next(iter(outs.values()))
        else:
            result = outs
        for fn in self._global_transforms:
            result = fn(result)
        return result

    def samples(self) -> List[Any]:
        return [self[i] for i in range(len(self))]
