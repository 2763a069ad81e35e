"""The bridge from a model configuration file to the program under test:
the program's ``ModelConfig`` for it, and the program's ``Model`` holding
the benchmark's weights (``perfbench/gen/weights.py``) as its parameters.
"""

from __future__ import annotations

from perfbench.gen import weights as wgen


def port_config(cfg: dict):
    """The program's ``ModelConfig`` of a dense-lead MoE decoder file."""
    from repro_torch.models.config import ModelConfig
    L, k = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    segments = tuple(seg for seg in ((("full:swiglu",), k),
                                     (("full:moe",), L - k)) if seg[1])
    return ModelConfig(
        name=cfg["name"], family="moe", d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        segments=segments, rope_theta=float(cfg["rope_theta"]),
        n_experts=cfg["n_routed_experts"], top_k=cfg["num_experts_per_tok"],
        moe_ff=cfg["moe_intermediate_size"],
        n_shared=cfg["n_shared_experts"],
        capacity_factor=cfg["capacity_factor"],
        aux_loss_weight=cfg["aux_loss_alpha"],
        compute_dtype=cfg["compute_dtype"])


def _param_names(cfg: dict, layer: int) -> str:
    k = cfg["first_k_dense_replace"]
    seg, i = (0, layer) if layer < k else (1 if k else 0, layer - k)
    return f"segments.{seg}.b0.{i}."


def _chunks(w, ff_axis: int, n_chunks: int):
    """Logical expert weights [E, a, b] in the program's chunk layout:
    chunk ``e * tp + j`` is expert e's j-th slice of its d_ff."""
    E, a, b = w.shape
    tp = n_chunks // E
    if tp == 1:
        return w
    if ff_axis == 2:
        return w.reshape(E, a, tp, b // tp).permute(0, 2, 1, 3) \
            .reshape(n_chunks, a, b // tp)
    return w.reshape(n_chunks, a // tp, b)


def program_names(cfg: dict, layer: int) -> dict:
    """{logical name (``perfbench/gen/weights.py``): the program's
    parameter name} of one layer (-1: the embedding, head, final norm)."""
    if layer < 0:
        return {"embed": "embed", "lm_head": "lm_head",
                "final_norm": "final_norm.scale"}
    p = _param_names(cfg, layer)
    out = {"ln_attn": p + "ln_attn.scale", "ln_mlp": p + "ln_mlp.scale"}
    out.update({n: p + "attn." + n for n in ("wq", "wk", "wv", "wo")})
    if layer < cfg["first_k_dense_replace"]:
        out.update({n: p + "mlp." + n for n in ("w_gate", "w_up", "w_down")})
        return out
    out.update({n: p + "moe." + n for n in ("router", "wg", "wu", "wd")})
    if cfg["n_shared_experts"]:
        out.update({"s_gate": p + "moe.shared.w_gate",
                    "s_up": p + "moe.shared.w_up",
                    "s_down": p + "moe.shared.w_down"})
    return out


def program_params(cfg: dict, seed: int, layer: int, device, dtype) -> dict:
    """One layer's weights (-1: the embedding, the head and the final
    norm) under the program's parameter names, experts in its chunk
    layout."""
    from repro_torch.models.moe import moe_chunking
    w = wgen.make(wgen.sizes(cfg), seed, layer, device, dtype)
    _, n_chunks = moe_chunking(cfg["n_routed_experts"])
    axis = {"wg": 2, "wu": 2, "wd": 1}
    return {prog: _chunks(w[n], axis[n], n_chunks) if n in axis else w[n]
            for n, prog in program_names(cfg, layer).items()}


def build(cfg: dict, seed: int, device, dtype):
    """The program's ``Model`` (``repro_torch.models.zoo.build``, shapes on
    ``meta``) with every parameter replaced by the benchmark's weights."""
    import torch
    from repro_torch.models.zoo import build as build_model
    model = build_model(port_config(cfg), device="meta", dtype=dtype)
    want = dict(model.named_parameters())
    for layer in range(-1, cfg["num_hidden_layers"]):
        for name, t in program_params(cfg, seed, layer, device, dtype).items():
            if tuple(want[name].shape) != tuple(t.shape):
                raise ValueError(f"{name}: {tuple(t.shape)} for "
                                 f"{tuple(want[name].shape)}")
            mod, leaf = name.rsplit(".", 1) if "." in name else ("", name)
            model.get_submodule(mod)._parameters[leaf] = \
                torch.nn.Parameter(t, requires_grad=False)
    left = [n for n, p in model.named_parameters() if p.is_meta]
    if left:
        raise ValueError(f"parameters not made: {left[:4]}")
    return model
