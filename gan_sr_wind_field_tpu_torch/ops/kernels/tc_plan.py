"""Constants of the tensor-core tiles' shared primitives
(``csrc/trunk_mma.cuh``: ``SK``, ``ZERO_BYTES``, ``SMEM_LIMIT``), for the
host plans of the trunk (``ops/rdb_trunk.py:plan_trunk_tc``) and the HR
head (``ops/hr_head.py:plan_head_tc``)."""

TC_SLICE = 32          # input channels per stage, 64-byte rows
TC_ZERO_BYTES = 64     # the row of zeros that masked taps read
TC_SMEM_LIMIT = 232448  # shared memory one block may have on the H100
