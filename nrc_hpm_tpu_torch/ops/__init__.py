"""The port's hand-written CUDA kernels, each module beside the plain
PyTorch versions its wrappers take for CPU tensors; ``_build`` compiles
them at first use.

``kernel_table()`` is the table of the counted kernel wrappers: every
wrapper of this layer that counts its launches in ``.launches``, by name,
with the symbol of its kernel as the profiler shows it.
``zero_launches()`` and ``read_launches()`` reset and read those counts.
The draw wrappers of ``utils/rng.py`` count their launches too, and are
not in the table.
"""


def kernel_table() -> dict:
    """{name: (wrapper, kernel symbol)} of every counted wrapper.  The
    modules are imported here, at the first call, so that importing one
    op module never imports the others."""
    from . import fused_encode_mlp as fem
    from . import fused_mlp as fm
    from . import hash_grid_train as hgt
    from . import macro_gather as mg
    from . import pw_kernels as pk
    from . import restir_reuse as rr
    from . import table_gather as tg

    return dict(
        pw_events=(pk.pw_events, "pw_events_kernel"),
        pw_profile=(pk.pw_profile, "pw_profile_kernel"),
        fused_encode_mlp=(fem.fused_encode_mlp_infer,
                          "fused_encode_mlp_kernel"),
        hash_grid_train_fwd=(hgt.hash_grid_train_fwd,
                             "hash_grid_train_fwd_kernel"),
        hash_grid_train_bwd=(hgt.hash_grid_train_bwd,
                             "hash_grid_train_bwd_kernel"),
        # both designs: fused_mlp_resident and fused_mlp_stream
        fused_mlp=(fm.fused_mlp_infer, "fused_mlp_"),
        table_gather=(tg.table_gather, "table_gather_kernel"),
        small_table_lookup=(mg.small_table_lookup,
                            "small_table_lookup_kernel"),
        temporal_reuse=(rr.temporal_reuse, "temporal_reuse_kernel"),
        spatial_reuse=(rr.spatial_reuse, "spatial_reuse_kernel"))


def zero_launches() -> None:
    """Set every counted wrapper's launches to 0."""
    for wrapper, _ in kernel_table().values():
        wrapper.launches = 0


def read_launches() -> dict:
    """{name: launches} of every counted wrapper."""
    return {name: w.launches for name, (w, _) in kernel_table().items()}
