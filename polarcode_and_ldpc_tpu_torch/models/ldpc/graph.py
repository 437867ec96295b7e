"""Tanner graph in dense padded-edge layout for batched message passing.

Messages live in two dense layouts:

* **check-major** ``[m, dc_max]`` — one row per check node, one slot per
  incident edge (padded; MacKay rows are not exactly regular);
* **var-major** ``[n, dv_max]`` — one row per variable node.

The two layouts are linked by *static* gather indices built here on the host:
``cv_gather`` pulls var-major messages into check-major order and
``vc_gather`` the reverse.  Slot order inside a row is ``np.nonzero`` order.
A decoder iteration is then two static gathers (``index_select``), row-wise
leave-one-out reductions, and elementwise math — no scatters, no dynamic
shapes.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...core.device import resolve_device

TABLE_NAMES = ("check_vars", "check_mask", "cv_gather",
               "var_checks", "var_mask", "vc_gather")


def tanner_tables_from_H(H: np.ndarray) -> dict:
    """The six index/mask tables of a parity-check matrix as numpy arrays."""
    H = (np.asarray(H) % 2).astype(np.int8)
    m, n = H.shape
    check_neighbors = [np.nonzero(H[c])[0] for c in range(m)]
    var_neighbors = [np.nonzero(H[:, v])[0] for v in range(n)]
    dc_max = max(1, max(len(x) for x in check_neighbors))
    dv_max = max(1, max(len(x) for x in var_neighbors))

    check_vars = np.zeros((m, dc_max), np.int32)
    check_mask = np.zeros((m, dc_max), bool)
    var_checks = np.zeros((n, dv_max), np.int32)
    var_mask = np.zeros((n, dv_max), bool)
    # slot of edge (c, v) in each layout
    slot_in_check: dict[tuple[int, int], int] = {}
    slot_in_var: dict[tuple[int, int], int] = {}
    for c, nbrs in enumerate(check_neighbors):
        for s, v in enumerate(nbrs):
            check_vars[c, s] = v
            check_mask[c, s] = True
            slot_in_check[(c, int(v))] = s
    for v, nbrs in enumerate(var_neighbors):
        for s, c in enumerate(nbrs):
            var_checks[v, s] = c
            var_mask[v, s] = True
            slot_in_var[(int(c), v)] = s

    cv_gather = np.zeros((m, dc_max), np.int32)
    for c, nbrs in enumerate(check_neighbors):
        for s, v in enumerate(nbrs):
            cv_gather[c, s] = int(v) * dv_max + slot_in_var[(c, int(v))]
    vc_gather = np.zeros((n, dv_max), np.int32)
    for v, nbrs in enumerate(var_neighbors):
        for s, c in enumerate(nbrs):
            vc_gather[v, s] = int(c) * dc_max + slot_in_check[(int(c), v)]
    return dict(check_vars=check_vars, check_mask=check_mask, cv_gather=cv_gather,
                var_checks=var_checks, var_mask=var_mask, vc_gather=vc_gather)


class TannerGraph(nn.Module):
    """The padded-edge tables of one code as buffers on one device.

    ``check_vars [m, dc_max]`` variable index per slot (0-padded),
    ``check_mask`` valid slots, ``cv_gather`` flat var-major edge index;
    ``var_checks [n, dv_max]``, ``var_mask``, ``vc_gather`` the reverse.
    """

    def __init__(self, tables: dict, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        cm = np.asarray(tables["check_mask"], bool)
        vm = np.asarray(tables["var_mask"], bool)
        self.m, self.dc_max = cm.shape
        self.n, self.dv_max = vm.shape
        self.num_edges = int(cm.sum())
        assert int(vm.sum()) == self.num_edges, "edge counts of the two layouts differ"
        for name in TABLE_NAMES:
            arr = np.asarray(tables[name])
            dtype = torch.bool if name.endswith("mask") else torch.int64
            self.register_buffer(name, torch.as_tensor(arr.astype(
                bool if name.endswith("mask") else np.int64), dtype=dtype, device=dev))

    @classmethod
    def from_H(cls, H: np.ndarray, device="cuda") -> "TannerGraph":
        return cls(tanner_tables_from_H(H), device)

    @property
    def device(self) -> torch.device:
        return self.check_mask.device

    def numpy_tables(self) -> dict:
        return {name: getattr(self, name).cpu().numpy() for name in TABLE_NAMES}

    # -- device helpers -------------------------------------------------------
    def gather_var_to_check(self, msgs_var: torch.Tensor) -> torch.Tensor:
        """[batch, n, dv_max] → [batch, m, dc_max] (check-major view)."""
        flat = msgs_var.reshape(*msgs_var.shape[:-2], self.n * self.dv_max)
        out = flat.index_select(-1, self.cv_gather.reshape(-1))
        return out.reshape(*msgs_var.shape[:-2], self.m, self.dc_max)

    def gather_check_to_var(self, msgs_check: torch.Tensor) -> torch.Tensor:
        """[batch, m, dc_max] → [batch, n, dv_max] (var-major view)."""
        flat = msgs_check.reshape(*msgs_check.shape[:-2], self.m * self.dc_max)
        out = flat.index_select(-1, self.vc_gather.reshape(-1))
        return out.reshape(*msgs_check.shape[:-2], self.n, self.dv_max)

    def syndrome(self, bits: torch.Tensor) -> torch.Tensor:
        """H·bits mod 2 per frame: ``[batch, n] → [batch, m]`` via gathers."""
        at_checks = bits.index_select(-1, self.check_vars.reshape(-1)).reshape(
            *bits.shape[:-1], self.m, self.dc_max)
        at_checks = at_checks.to(torch.int32) * self.check_mask
        return at_checks.sum(dim=-1) % 2
