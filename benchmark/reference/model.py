"""ALIGNN and ALIGNN-FF in plain PyTorch, as functions of a parameter dict.

The equations are those of the published models (Choudhary & DeCost,
npj Comput. Mater. 7, 185, 2021; ALIGNN-FF, Digital Discovery 2, 346,
2023), with the settings of the configuration files:

    bond features   RBF(b, 0..8 A, 80 bins), b the bond length, or with
                    the cutoff function the envelope value
                    1 + c1 x^p + c2 x^(p+1) + c3 x^(p+2), x = b / inner_cutoff,
                    0 beyond it (p = exponent)
    angle features  RBF(cos theta, -1..1, 40 bins)
    RBF             exp(-gamma (v - mu_k)^2) with gamma = 1 / (mu_1 - mu_0)
                    (the published code's lengthscale, not squared)
    MLP             SiLU(norm(W v + b))
    EGGC(x, e)      m_e = W_sg x_src + W_dg x_dst + W_eg e
                    h_i = sum_{e->i} sigma(m_e) W_du x_src
                          / (sum_{e->i} sigma(m_e) + 1e-6)
                    x'  = x + SiLU(norm(W_su x + h)),  e' = e + SiLU(norm(m))
    ALIGNN layer    x, m = EGGC_g(x, y);  y, z = EGGC_L(g)(m, z)
    readout         mean of x over each structure's atoms, then fc

``norm`` is LayerNorm (eps 1e-5) in the force field and BatchNorm (batch
statistics, biased variance, eps 1e-5) in the property model.  The force
field's energy is fc(readout) times the atom count plus the short-bond
penalty summed over the batch; its forces are -dE/dr summed into each
bond's end atom minus its start atom.  The angle cosine is clipped to
[-1, 1] by min/max, so that the gradient at the bound is 1/2 (the JAX
package's ``jnp.clip``, which the program under test follows); the
published code uses ``torch.clamp`` there.

Nothing here imports the program under test; the parameter names are the
program's state-dict names, so that one dict of tensors drives both.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

_ELEMENTS = os.path.join(os.path.dirname(__file__), "data", "elements.json")


def elements() -> dict:
    with open(_ELEMENTS) as f:
        return json.load(f)["elements"]


def feature_rows(z: np.ndarray) -> np.ndarray:
    """[N, 92] cgcnn one-hot rows of atomic numbers `z`."""
    by_z = {e["z"]: e["cgcnn_ones"] for e in elements().values()}
    out = np.zeros((len(z), 92))
    for k, zz in enumerate(np.asarray(z).tolist()):
        out[k, by_z[zz]] = 1.0
    return out


def masses(z: np.ndarray) -> np.ndarray:
    by_z = {e["z"]: e["mass"] for e in elements().values()}
    return np.asarray([by_z[zz] for zz in np.asarray(z).tolist()])


# --- parameters -------------------------------------------------------------

def eggc_linears(prefix: str) -> List[str]:
    return [f"{prefix}.{k}" for k in ("src_gate", "dst_gate", "edge_gate",
                                      "src_update", "dst_update")]


def shapes(cfg: dict, property_model: bool) -> Dict[str, tuple]:
    """{name: shape} of every parameter (weights [out, in])."""
    hid, emb = cfg["hidden_features"], cfg["embedding_features"]
    out: Dict[str, tuple] = {}

    def linear(name, fin, fout):
        out[name + ".weight"] = (fout, fin)
        out[name + ".bias"] = (fout,)

    def norm(name, f):
        out[name + ".weight"] = (f,)
        out[name + ".bias"] = (f,)

    def mlp(name, fin, fout):
        linear(name + ".linear", fin, fout)
        norm(name + ".norm", fout)

    def eggc(name):
        for lin in eggc_linears(name):
            linear(lin, hid, hid)
        norm(name + ".norm_nodes", hid)
        norm(name + ".norm_edges", hid)

    mlp("embeddings.atom_embedding", cfg["atom_input_features"], hid)
    mlp("embeddings.edge_embedding_0", cfg["edge_input_features"], emb)
    mlp("embeddings.edge_embedding_1", emb, hid)
    mlp("embeddings.angle_embedding_0", cfg["triplet_input_features"], emb)
    mlp("embeddings.angle_embedding_1", emb, hid)
    for i in range(cfg["alignn_layers"]):
        eggc(f"trunk.alignn_layers_{i}.node_update")
        eggc(f"trunk.alignn_layers_{i}.edge_update")
    for i in range(cfg["gcn_layers"]):
        eggc(f"trunk.gcn_layers_{i}")
    linear("fc", hid, cfg["output_features"])
    return out


def is_norm(name: str) -> bool:
    return any("norm" in part for part in name.split(".")[:-1])


def decays(name: str) -> bool:
    """The published ``group_decay``: no weight decay on biases and on
    the parameters of norm layers."""
    return not name.endswith(".bias") and not is_norm(name)


def init_params(cfg: dict, property_model: bool, generator: torch.Generator,
                device) -> Params:
    """Fresh weights drawn from `generator` in one call on `device`:
    Linear weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's
    ``nn.Linear`` law), norm scales 1 and shifts 0, and the output bias
    log(0.7) under a log link."""
    shp = shapes(cfg, property_model)
    linear = [n for n in shp if not is_norm(n)]
    total = sum(math.prod(shp[n]) for n in linear)
    u = torch.rand(total, generator=generator, device=device) * 2 - 1
    params, off = {}, 0
    for name in shp:
        if is_norm(name):
            fill = 1.0 if name.endswith(".weight") else 0.0
            params[name] = torch.full(shp[name], fill, device=device)
            continue
        n = math.prod(shp[name])
        fan_in = shp[name.rsplit(".", 1)[0] + ".weight"][1]
        params[name] = (u[off:off + n] / math.sqrt(fan_in)).reshape(shp[name])
        off += n
    if cfg.get("link") == "log":
        params["fc.bias"].fill_(math.log(0.7))
    return params


# --- layers -----------------------------------------------------------------

def linear(p: Params, name: str, x):
    return x @ p[name + ".weight"].t() + p[name + ".bias"]


def layer_norm(p: Params, name: str, x, mask=None):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5) * p[name + ".weight"] + \
        p[name + ".bias"]


def batch_norm(p: Params, name: str, x, mask=None):
    """Training-mode BatchNorm over the rows (biased variance)."""
    mean = x.mean(0)
    var = ((x - mean) ** 2).mean(0)
    return (x - mean) / torch.sqrt(var + 1e-5) * p[name + ".weight"] + \
        p[name + ".bias"]


def rbf(v, vmin: float, vmax: float, bins: int):
    centers = torch.linspace(vmin, vmax, bins, dtype=torch.float64)
    gamma = 1.0 / float((centers[1:] - centers[:-1]).mean())
    return torch.exp(-gamma * (v[:, None] - centers.to(v)) ** 2)


def mlp(p, name, x, norm):
    return F.silu(norm(p, name + ".norm", linear(p, name + ".linear", x)))


def eggc(p, name, x, e, src, dst, norm):
    m = (linear(p, name + ".src_gate", x)[src]
         + linear(p, name + ".dst_gate", x)[dst]
         + linear(p, name + ".edge_gate", e))
    sigma = torch.sigmoid(m)
    bh = linear(p, name + ".dst_update", x)[src]
    num = torch.zeros_like(x).index_add(0, dst, sigma * bh)
    den = torch.zeros_like(x).index_add(0, dst, sigma)
    h = num / (den + 1e-6)
    x_new = x + F.silu(norm(p, name + ".norm_nodes",
                            linear(p, name + ".src_update", x) + h))
    e_new = e + F.silu(norm(p, name + ".norm_edges", m))
    return x_new, e_new


def envelope(b, inner_cutoff: float, p: int):
    x = b / inner_cutoff
    c1 = -(p + 1) * (p + 2) / 2
    c2 = p * (p + 2)
    c3 = -p * (p + 1) / 2
    env = 1 + c1 * x ** p + c2 * x ** (p + 1) + c3 * x ** (p + 2)
    return torch.where(b <= inner_cutoff, env, torch.zeros_like(b))


def cosines(r, lg_src, lg_dst):
    r1, r2 = -r[lg_src], r[lg_dst]
    cos = (r1 * r2).sum(1) / (torch.linalg.norm(r1, dim=1)
                              * torch.linalg.norm(r2, dim=1))
    return torch.minimum(torch.maximum(cos, cos.new_full((), -1.0)),
                         cos.new_full((), 1.0))


def forward(p: Params, cfg: dict, b: dict, r, property_model: bool):
    """Per-structure output [G, T] of a batch `b` (dict of index tensors:
    feats [N, 92], src, dst, lg_src, lg_dst, node_graph, n_nodes [G])."""
    norm = batch_norm if property_model else layer_norm
    bond = torch.linalg.norm(r, dim=1)
    feat = bond
    if cfg.get("use_cutoff_function"):
        feat = envelope(bond, cfg["inner_cutoff"], cfg["exponent"])
    x = mlp(p, "embeddings.atom_embedding", b["feats"], norm)
    y = mlp(p, "embeddings.edge_embedding_1", mlp(
        p, "embeddings.edge_embedding_0",
        rbf(feat, 0.0, 8.0, cfg["edge_input_features"]), norm), norm)
    z = mlp(p, "embeddings.angle_embedding_1", mlp(
        p, "embeddings.angle_embedding_0",
        rbf(cosines(r, b["lg_src"], b["lg_dst"]), -1.0, 1.0,
            cfg["triplet_input_features"]), norm), norm)
    for i in range(cfg["alignn_layers"]):
        x, m = eggc(p, f"trunk.alignn_layers_{i}.node_update", x, y,
                    b["src"], b["dst"], norm)
        y, z = eggc(p, f"trunk.alignn_layers_{i}.edge_update", m, z,
                    b["lg_src"], b["lg_dst"], norm)
    for i in range(cfg["gcn_layers"]):
        x, y = eggc(p, f"trunk.gcn_layers_{i}", x, y, b["src"], b["dst"],
                    norm)
    g = b["n_nodes"].shape[0]
    pooled = torch.zeros(g, x.shape[1], dtype=x.dtype, device=x.device) \
        .index_add(0, b["node_graph"], x) / b["n_nodes"][:, None]
    out = linear(p, "fc", pooled)
    if cfg.get("link") == "log":
        out = torch.exp(out)
    return out, bond


def energy_forces(p: Params, cfg: dict, b: dict, r, create_graph=False):
    """(per-structure out [G], total energy, forces [N, 3]) of the force
    field: E = sum_g (out_g n_g) + G * penalty, F = -dE/dr assembled."""
    r = r if r.requires_grad else r.detach().requires_grad_(True)
    with torch.enable_grad():
        out, bond = forward(p, cfg, b, r, property_model=False)
        en = out[:, 0] * b["n_nodes"] if cfg.get("energy_mult_natoms") \
            else out[:, 0]
        if cfg.get("use_penalty"):
            th, fac = cfg["penalty_threshold"], cfg["penalty_factor"]
            pen = torch.where(bond < th, fac * (th - bond),
                              torch.zeros_like(bond)).sum()
            en = en + pen
        energy = en.sum()
        (g_r,) = torch.autograd.grad(energy, r, create_graph=create_graph)
    pair = cfg.get("grad_multiplier", -1.0) * g_r
    n = b["feats"].shape[0]
    forces = torch.zeros(n, 3, dtype=r.dtype, device=r.device) \
        .index_add(0, b["dst"], pair)
    if cfg.get("add_reverse_forces"):
        forces = forces - torch.zeros(n, 3, dtype=r.dtype, device=r.device) \
            .index_add(0, b["src"], pair)
    return out[:, 0], energy, forces


def batch_tensors(graphs, device, dtype=torch.float32) -> dict:
    """Concatenate reference graphs into one unpadded batch on `device`."""
    feats, src, dst, lg_src, lg_dst, ng, nn_, r = [], [], [], [], [], [], \
        [], []
    n_off = e_off = 0
    for k, g in enumerate(graphs):
        n, e, _ = g.counts
        feats.append(feature_rows(g.z))
        src.append(g.src + n_off)
        dst.append(g.dst + n_off)
        lg_src.append(g.lg_src + e_off)
        lg_dst.append(g.lg_dst + e_off)
        ng.append(np.full(n, k))
        nn_.append(n)
        r.append(g.r)
        n_off += n
        e_off += e

    def t(a, dt):
        return torch.as_tensor(np.concatenate(a) if isinstance(a, list)
                               else a, dtype=dt, device=device)

    i64 = torch.int64
    return {"feats": t(feats, dtype), "src": t(src, i64), "dst": t(dst, i64),
            "lg_src": t(lg_src, i64), "lg_dst": t(lg_dst, i64),
            "node_graph": t(ng, i64),
            "n_nodes": torch.as_tensor(nn_, dtype=dtype, device=device),
            "r": t(r, dtype)}
