"""Plain PyTorch reference of the decoder with a dense lead and MoE layers
(deepseek-moe-16b's block): float32, no kernels, no cache, no batching
beyond the calls it follows, one layer's weights at a time.

It follows the configuration as the program runs it: RMSNorm (eps 1e-6,
statistics in f32), rotary embeddings on the two halves of each head,
causal softmax attention with scale ``1/sqrt(D)``, SwiGLU; the MoE's
router is an f32 softmax whose top ``k`` gates are renormalised to sum to
1, each expert takes at most ``capacity = ceil(n * k / E * factor)``
pairs of (token, choice) from a call of ``n`` tokens, in token-major order
(the rest are dropped), and the shared experts see every token; the loss
is the mean next-token cross-entropy plus ``aux_weight`` times each MoE
layer's load-balancing loss ``E * sum(mean gate * share of choices)``.

A served batch is one prefill call of ``B * P`` tokens and then one call of
``B`` tokens a decode step; the capacity of each call is its own. The
reference works every position of the batch at once, layer by layer, with
each call's tokens routed under that call's capacity, which gives what a
prefill followed by decode steps through a cache gives.

``precision="fp8"`` rounds every product's operands to float8 e4m3 (per
tensor, scaled to its largest magnitude) before an f32 product: the
control one precision below the served bfloat16.

It imports nothing of the program; the weights come from
``perfbench/gen/weights.py``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.gen import weights as wgen

E4M3_MAX = 448.0


def _fp8(x):
    s = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Reference:
    def __init__(self, cfg: dict, seed: int, device, served_dtype,
                 precision: str = "fp32"):
        self.cfg = cfg
        self.m = wgen.sizes(cfg)
        self.seed, self.device = seed, device
        self.served_dtype = served_dtype
        self.precision = precision
        self.eps = cfg["rms_norm_eps"]

    # -- weights ----------------------------------------------------------
    def weights(self, layer: int) -> dict:
        """The benchmark's weights of ``layer`` (-1: embedding and head)
        made again from the seed, as float32."""
        w = wgen.make(self.m, self.seed, layer, self.device,
                      self.served_dtype)
        return {k: v.float() for k, v in w.items()}

    # -- pieces -------------------------------------------------------------
    def mm(self, x, w):
        if self.precision == "fp8":
            return _fp8(x) @ _fp8(w)
        return x @ w

    def rmsnorm(self, x, scale):
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * scale

    def rope(self, x, pos):
        half = x.shape[-1] // 2
        freqs = 1.0 / (self.cfg["rope_theta"] ** (
            torch.arange(half, dtype=torch.float32, device=x.device) / half))
        ang = pos.float()[:, None] * freqs
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def attention(self, w, x, pos):
        B, S, d = x.shape
        H, Hkv, D = self.m["heads"], self.m["kv_heads"], self.m["head_dim"]
        q = self.mm(x, w["wq"].reshape(d, H * D)).view(B, S, H, D)
        k = self.mm(x, w["wk"].reshape(d, Hkv * D)).view(B, S, Hkv, D)
        v = self.mm(x, w["wv"].reshape(d, Hkv * D)).view(B, S, Hkv, D)
        q, k = self.rope(q, pos), self.rope(k, pos)
        rep = H // Hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # [B, H, S, D]
        if self.precision == "fp8":
            q, k = _fp8(q), _fp8(k)
        scores = q @ k.transpose(-1, -2) / math.sqrt(D)
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        if self.precision == "fp8":
            probs, v = _fp8(probs), _fp8(v)
        o = (probs @ v).transpose(1, 2).reshape(B, S, H * D)
        return self.mm(o, w["wo"].reshape(H * D, d))

    def swiglu(self, x, g, u, dn):
        return self.mm(F.silu(self.mm(x, g)) * self.mm(x, u), dn)

    def capacity(self, n: int) -> int:
        k, E = self.m_k, self.m["experts"]
        return max(1, math.ceil(n * k / E * self.cfg["capacity_factor"]))

    @property
    def m_k(self) -> int:
        return self.cfg["num_experts_per_tok"]

    def moe(self, w, xt, calls, want_aux: bool = True):
        """xt [T, d]; ``calls``: a call id a token (each call's tokens
        contiguous and in token order) -> (y [T, d], the aux loss of each
        call when ``want_aux``)."""
        T, d = xt.shape
        E, k = self.m["experts"], self.m_k
        gates = torch.softmax(self.mm(xt, w["router"]), dim=-1)
        top, idx = torch.topk(gates, k, dim=-1)
        top = top / torch.clamp(top.sum(-1, keepdim=True), min=1e-9)
        flat_e = idx.reshape(-1)
        call = calls.repeat_interleave(k)
        sizes = torch.bincount(calls)
        cap = torch.tensor([self.capacity(int(n)) for n in sizes.tolist()],
                           device=xt.device)
        # a pair's place among the earlier pairs of its call and expert
        key = call * E + flat_e
        order = torch.argsort(key, stable=True)
        _, counts = torch.unique_consecutive(key[order], return_counts=True)
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.empty_like(key)
        rank[order] = torch.arange(len(key), device=xt.device) \
            - starts.repeat_interleave(counts)
        keep = rank < cap[call]
        pair_w = top.reshape(-1)
        y = torch.zeros_like(xt)
        for e in range(E):
            sel = torch.nonzero(keep & (flat_e == e))[:, 0]
            if not len(sel):
                continue
            tok = sel // k
            out = self.swiglu(xt[tok], w["wg"][e], w["wu"][e], w["wd"][e])
            y = y.index_add(0, tok, out * pair_w[sel, None])
        if "s_gate" in w:
            y = y + self.swiglu(xt, w["s_gate"], w["s_up"], w["s_down"])
        aux = []
        for c in range(len(sizes) if want_aux else 0):
            rows = calls == c
            me = gates[rows].mean(dim=0)
            ce = torch.bincount(idx[rows].reshape(-1), minlength=E).float() \
                / (int(sizes[c]) * k)
            aux.append(E * torch.sum(me * ce))
        return y, aux

    def block(self, w, layer: int, h, pos, calls, want_aux: bool = True):
        """One layer over h [B, S, d]; ``calls`` [B * S] the call id of each
        token in row-major order (the MoE routes each call under its own
        capacity, its tokens in row-major order). Returns (h, aux list)."""
        x = h + self.attention(w, self.rmsnorm(h, w["ln_attn"]), pos)
        xn = self.rmsnorm(x, w["ln_mlp"])
        if layer < self.m["dense_layers"]:
            return x + self.swiglu(xn, w["w_gate"], w["w_up"], w["w_down"]), []
        B, S, d = xn.shape
        n = B * S
        order = torch.argsort(calls * n + torch.arange(n, device=h.device))
        y, aux = self.moe(w, xn.reshape(n, d)[order], calls[order], want_aux)
        out = torch.empty_like(y)
        out[order] = y
        return x + out.view(B, S, d), aux

    # -- serving --------------------------------------------------------------
    def served_logits(self, tokens, prompt_len: int):
        """tokens [B, P + n - 1] (prompts of P tokens and the first n - 1
        served tokens) -> f32 logits [B, n, V] at the positions that
        predicted served tokens 0..n-1 (the prefill's last position, then
        each decode step's), under the calls the program made: one prefill
        of ``B * P`` tokens, then one call of ``B`` tokens a decode
        step."""
        B, S = tokens.shape
        pos = torch.arange(S, device=self.device)
        # the call of each (row, position): the prefill is call 0, decode
        # step t (position P - 1 + t) call t
        step = torch.clamp(pos - prompt_len + 1, min=0)
        calls = step[None, :].expand(B, S).reshape(-1)
        g = self.weights(-1)
        h = g["embed"][tokens]
        del g
        for layer in range(self.m["layers"]):
            w = self.weights(layer)
            h, _ = self.block(w, layer, h, pos, calls, want_aux=False)
            del w
        g = self.weights(-1)
        last = self.rmsnorm(h[:, prompt_len - 1:], g["final_norm"])
        return self.mm(last, g["lm_head"])

    # -- training ---------------------------------------------------------------
    def loss(self, params: dict, tokens):
        """The mean next-token loss plus the aux term, over ``params``
        ({layer: weights}, -1 the embedding and head) on tokens [B, S+1];
        each layer recomputed in the backward."""
        from torch.utils.checkpoint import checkpoint
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        B, S = inputs.shape
        pos = torch.arange(S, device=tokens.device)
        calls = torch.zeros(B * S, dtype=torch.long, device=tokens.device)
        h = params[-1]["embed"][inputs]
        aux_total = 0.0
        for layer in range(self.m["layers"]):
            def run(h, *flat, layer=layer, keys=tuple(params[layer])):
                w = dict(zip(keys, flat))
                h, aux = self.block(w, layer, h, pos, calls)
                return h, sum(aux) if aux else torch.zeros((), device=h.device)
            h, aux = checkpoint(run, h, *params[layer].values(),
                                use_reentrant=False)
            aux_total = aux_total + aux
        logits = self.mm(self.rmsnorm(h, params[-1]["final_norm"]),
                         params[-1]["lm_head"])
        logp = torch.log_softmax(logits, dim=-1)
        xent = -logp.gather(-1, labels[..., None])[..., 0].mean()
        return xent + self.cfg["aux_loss_alpha"] * aux_total
