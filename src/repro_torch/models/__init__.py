"""Model zoo: unified transformer covering dense / MoE / SSM / hybrid /
VLM-backbone / audio-enc-dec families, in plain torch ops."""
from .module import (
    Creator,
    count_params,
    opt_state_from_reference,
    params_from_reference,
    tree_bytes,
)
from .transformer import (
    decode_chunk,
    decode_step,
    forward,
    init_cache,
    init_paged_cache,
    init_params,
    param_specs,
    prefill_cross_attention,
)
