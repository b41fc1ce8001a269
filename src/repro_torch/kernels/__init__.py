"""Hand-written CUDA kernels of the port, with their plain PyTorch
versions; `ops` holds the public wrappers."""
# The reference's exports, but for `decdiff_update`, `gather_rows` and
# `neighbor_avg`: bound here they would hide the kernel modules of the
# same names; call them as `ops.<name>`.
from repro_torch.kernels.ops import (  # noqa: F401
    decdiff_update_tree,
    decode_attention_fused,
    dequant_neighbor_avg,
    dequant_neighbor_avg_rows,
    vt_kl_loss_fused,
)
