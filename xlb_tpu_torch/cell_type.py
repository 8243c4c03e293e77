"""Cell-type tag constants stored in the uint8 ``bc_mask`` field.

0 marks plain fluid, 1-253 are boundary-condition ids handed out by the
registry, 254 tags simple fluid voxels (multires fast path) and 255 tags
solid voxels -- the same codes as ``xlb_tpu.cell_type``.
"""

BC_NONE = 0
BC_SFV = 254
BC_SOLID = 255
