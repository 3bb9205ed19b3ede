from repro_torch.checkpoint.store import (  # noqa: F401
    checkpoint_step,
    decode_tag,
    encode_tag,
    load_extras,
    load_pytree,
    npz_keys,
    save_pytree,
)
