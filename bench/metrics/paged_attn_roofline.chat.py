"""paged_attn_roofline.chat: the paged decode kernel's share of its
roofline over the traced slice: the least time the card could take for the
work of the slice's decode steps (each live row's committed length, one
query a row, in every layer; ``pbench.work.paged_decode``) over the device
time of the kernels named in ``KERNELS``. Layer: the kernels."""
from pbench.work import paged_decode

KERNELS = ("paged_decode_kernel",)


def read(run):
    s = run.slice
    if s is None:
        return None
    busy = s.kernel_s(KERNELS)
    m = run.model
    bound = sum(paged_decode(st.decode, n_heads=m["n_heads"], n_kv_heads=m["n_kv_heads"],
                             head_dim=m["head_dim"]).bound_s()
                for st in run.slice_steps() if st.decode) * m["num_layers"]
    return bound / busy * 100 if busy > 0 and bound > 0 else None
