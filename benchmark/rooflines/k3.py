"""K3, ``fused_encode_mlp_kernel``: the cache's inference, hash-grid +
OneBlob encode and the bias-free MLP, on n samples.

Bytes: the 20 bytes of x5 read and the float32 outputs written per
sample; the bf16-packed table and the bf16 weights read once.
Operations: the MLP's bf16 products (a multiply and an add per weight) and
the encode's float32 work (150 a sample and level: cell, 8 corner weights
and indices, 16 products and sums)."""

KERNEL = "fused_encode_mlp_kernel"
WRAPS = ("nrc_hpm_tpu_torch.ops.fused_encode_mlp", "fused_encode_mlp_infer")
LEVEL_OPS = 150


def sizes(packed_table, layers, x5, spec, *rest, **kw):
    return dict(n=int(x5.shape[0]), table_words=int(packed_table.numel()),
                shapes=[tuple(w.shape) for w in layers],
                levels=int(spec.n_levels))


def cost(n: int, table_words: int, shapes, levels: int) -> dict:
    out_dim = shapes[-1][1]
    weights = sum(a * b for a, b in shapes)
    return dict(n_bytes=n * (20 + 4 * out_dim) + 4 * table_words
                + 2 * weights,
                bf16_ops=n * sum(2 * a * b for a, b in shapes),
                f32_ops=n * levels * LEVEL_OPS)
