"""Registry handing out the uint8 ids stored in ``bc_mask``.

Ids start at 1 and follow construction order, exactly as in
``xlb_tpu.boundary.registry``, so the same scene built in both packages
gets the same ids and bit-equal masks. Id 0 is reserved for plain fluid;
254/255 are reserved cell-type tags (see ``xlb_tpu_torch.cell_type``).
"""

from xlb_tpu_torch.cell_type import BC_SFV


class BoundaryConditionRegistry:
    def __init__(self):
        self.id_to_bc = {}
        self.bc_to_id = {}
        self.next_id = 1  # 0 reserved for fluid

    def register_boundary_condition(self, name: str) -> int:
        bc_id = self.next_id
        if bc_id >= BC_SFV:
            raise RuntimeError(f"boundary-condition id space exhausted (max {BC_SFV - 1})")
        self.next_id += 1
        self.id_to_bc[bc_id] = name
        self.bc_to_id[name] = bc_id
        return bc_id

    def reset(self):
        self.__init__()


boundary_condition_registry = BoundaryConditionRegistry()
