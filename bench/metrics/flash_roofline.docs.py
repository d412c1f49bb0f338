"""flash_roofline.docs: the flash prefill kernel's share of its roofline
over the traced slice: the least time for the causal attention of the
prompts prefilled in the slice's steps (real tokens only, in every layer;
``pbench.work.flash_prefill``) over the device time of the kernels named
in ``KERNELS``. Layer: the kernels."""
from pbench.work import flash_prefill

KERNELS = ("flash_kernel",)


def read(run):
    s = run.slice
    if s is None:
        return None
    busy = s.kernel_s(KERNELS)
    m = run.model
    bound = sum(flash_prefill(n, n_heads=m["n_heads"], n_kv_heads=m["n_kv_heads"],
                              head_dim=m["head_dim"]).bound_s()
                for st in run.slice_steps() for n in st.prefill) * m["num_layers"]
    return bound / busy * 100 if busy > 0 and bound > 0 else None
