"""Batched expression-tree surgery on flat postorder tensors.

Counterpart of ``symbolicregression_jl_tpu/ops/treeops.py``. The JAX package
writes each function for ONE tree and ``vmap``s it; here every function
takes a batch with a leading lane axis — fields ``[L, N]`` and ``length
[L]`` — and is written as plain tensor ops, so the device engine
(ops/evolve.py) runs tree surgery for all lanes with a fixed number of
launches and no host round trip.

The enabling invariant is postorder contiguity: the subtree rooted at slot
``p`` occupies exactly ``[p - size(p) + 1, p]`` and every child pointer
targets a smaller slot. Two consequences the port uses in place of the JAX
package's per-slot ``fori_loop``s:

- subtree sizes follow from the arity sequence alone. With stack heights
  ``h_k = sum_{j<k} (1 - arity_j)``, the subtree rooted at ``i`` starts at
  the last ``s <= i`` with ``h_s == h_{i+1} - 1`` (one ``[L, N, N]``
  comparison instead of an N-step loop);
- a binary node's right child is the slot just before it and its left
  child ends just before the right child's subtree, so child pointers of a
  freshly drawn arity sequence need no stack simulation.

For every canonical tree (the only kind the engine holds) the results equal
the JAX package's pointer recurrences exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .flat import KIND_BINARY, KIND_CONST, KIND_PAD, KIND_UNARY, KIND_VAR

__all__ = [
    "Tree",
    "gather_slots",
    "subtree_sizes",
    "subtree_start",
    "tree_depth",
    "extract_block",
    "replace_range",
    "random_tree",
    "select_tree",
    "cat_trees",
]


class Tree(NamedTuple):
    """A batch of flat postorder trees: fields [L, N], length [L]."""

    kind: torch.Tensor  # int32 [L, N]
    op: torch.Tensor  # int32 [L, N]
    lhs: torch.Tensor  # int32 [L, N]
    rhs: torch.Tensor  # int32 [L, N]
    feat: torch.Tensor  # int32 [L, N]
    val: torch.Tensor  # float [L, N]
    length: torch.Tensor  # int32 [L]

    @property
    def n_slots(self) -> int:
        return self.kind.shape[1]


def _iota(tree: Tree) -> torch.Tensor:
    return torch.arange(tree.n_slots, device=tree.kind.device, dtype=torch.int32)


def select_tree(flag: torch.Tensor, a: Tree, b: Tree) -> Tree:
    """Per lane: ``a`` where ``flag`` [L], else ``b``."""
    return Tree(*(
        torch.where(flag.view((-1,) + (1,) * (x.dim() - 1)), x, y)
        for x, y in zip(a, b)
    ))


def cat_trees(a: Tree, b: Tree) -> Tree:
    return Tree(*(torch.cat([x, y], 0) for x, y in zip(a, b)))


def gather_slots(tree: Tree, src: torch.Tensor):
    """The six field arrays gathered at per-slot indices ``src`` [L, N]
    (each lane reads its own slots). The JAX package routes this through a
    one-hot matmul because per-lane gathers are slow on the TPU; a GPU
    gathers directly, and non-finite constants need no special coding."""
    idx = src.long()
    return tuple(
        torch.gather(f, 1, idx)
        for f in (tree.kind, tree.op, tree.lhs, tree.rhs, tree.feat, tree.val)
    )


def _arity(kind: torch.Tensor) -> torch.Tensor:
    return torch.where(
        kind == KIND_BINARY, 2, torch.where(kind == KIND_UNARY, 1, 0)
    ).to(torch.int32)


def _sizes_from_arity(arity: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """Subtree sizes [L, N] of postorder arity sequences (0 on pad slots)."""
    L, N = arity.shape
    step = torch.where(live, 1 - arity, 0)
    h = torch.cat(
        [torch.zeros((L, 1), dtype=torch.int32, device=arity.device),
         torch.cumsum(step, 1, dtype=torch.int32)], 1,
    )  # [L, N+1]
    target = h[:, 1:] - 1  # [L, N]: h_{i+1} - 1 per root slot i
    k = torch.arange(N, device=arity.device, dtype=torch.int32)
    hit = (h[:, None, :N] == target[:, :, None]) & (k[None, None, :] <= k[None, :, None])
    start = torch.amax(torch.where(hit, k[None, None, :], -1), dim=2)  # [L, N]
    return torch.where(live, k[None, :] - start + 1, 0).to(torch.int32)


def subtree_sizes(tree: Tree) -> torch.Tensor:
    """size[l, i] = node count of the subtree rooted at slot i (0 on pads)."""
    live = _iota(tree)[None, :] < tree.length[:, None]
    return _sizes_from_arity(_arity(tree.kind), live & (tree.kind != KIND_PAD))


def subtree_start(sizes: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """First slot of the subtree rooted at p [L] (inclusive)."""
    return p - torch.gather(sizes, 1, p.long()[:, None])[:, 0] + 1


def tree_depth(tree: Tree, sizes: torch.Tensor | None = None) -> torch.Tensor:
    """Max node depth [L] (root = 1): a slot's depth is the number of live
    subtrees that contain it."""
    if sizes is None:
        sizes = subtree_sizes(tree)
    k = _iota(tree)
    start = k[None, :] - sizes + 1  # [L, N]
    live = sizes > 0
    inside = (
        live[:, :, None]
        & (start[:, :, None] <= k[None, None, :])
        & (k[None, None, :] <= k[None, :, None])
    )  # [L, i, j]: slot j lies in the subtree of slot i
    depth = inside.sum(1, dtype=torch.int32)  # [L, N]
    return torch.amax(torch.where(live, depth, 0), dim=1).to(torch.int32)


def extract_block(tree: Tree, a: torch.Tensor, b: torch.Tensor) -> Tree:
    """Materialize subtree block [a, b) of every lane at offset 0: fields
    shifted left by a, internal child pointers rebased, root at b-a-1."""
    N = tree.n_slots
    j = _iota(tree)[None, :]
    a2 = a[:, None]
    src = torch.clamp(j + a2, 0, N - 1)
    m = (b - a).to(torch.int32)
    inside = j < m[:, None]
    g_kind, g_op, g_lhs, g_rhs, g_feat, g_val = gather_slots(tree, src)
    kind = torch.where(inside, g_kind, KIND_PAD)
    return Tree(
        kind=kind,
        op=torch.where(inside, g_op, 0),
        lhs=torch.where(inside & (kind >= KIND_UNARY), torch.clamp_min(g_lhs - a2, 0), 0),
        rhs=torch.where(inside & (kind == KIND_BINARY), torch.clamp_min(g_rhs - a2, 0), 0),
        feat=torch.where(inside, g_feat, 0),
        val=torch.where(inside, g_val, torch.zeros_like(g_val)),
        length=m,
    )


def replace_range(tree: Tree, a: torch.Tensor, b: torch.Tensor, mat: Tree) -> Tree:
    """Replace slot range [a, b) — a whole subtree block — of every lane
    with material ``mat`` (a block at offset 0, root at mat.length-1). New
    length = L - (b-a) + m; callers reject oversize results afterwards."""
    N = tree.n_slots
    j = _iota(tree)[None, :]
    m = mat.length[:, None]
    a2, b2 = a[:, None], b[:, None]
    shift = m - (b2 - a2)
    new_len = tree.length[:, None] + shift

    reg_pre = j < a2
    reg_mat = (j >= a2) & (j < a2 + m)
    reg_post = (j >= a2 + m) & (j < new_len)

    src_tree = torch.clamp(torch.where(reg_pre, j, j - shift), 0, N - 1)
    src_mat = torch.clamp(j - a2, 0, N - 1)
    t_kind, t_op, t_lhs, t_rhs, t_feat, t_val = gather_slots(tree, src_tree)
    m_kind, m_op, m_lhs, m_rhs, m_feat, m_val = gather_slots(mat, src_mat)

    def pick(tree_arr, mat_arr, fill):
        return torch.where(reg_mat, mat_arr, torch.where(reg_pre | reg_post, tree_arr, fill))

    kind = pick(t_kind, m_kind, KIND_PAD)
    op = pick(t_op, m_op, 0)
    feat = pick(t_feat, m_feat, 0)
    val = pick(t_val, m_val, torch.zeros_like(t_val))

    def remap_ptr(c, ptr_mat):
        c_post = torch.where(c < a2, c, torch.where(c == b2 - 1, a2 + m - 1, c + shift))
        return torch.where(
            reg_mat, ptr_mat + a2,
            torch.where(reg_pre, c, torch.where(reg_post, c_post, 0)),
        )

    lhs = torch.where(kind >= KIND_UNARY, torch.clamp(remap_ptr(t_lhs, m_lhs), 0, N - 1), 0)
    rhs = torch.where(kind == KIND_BINARY, torch.clamp(remap_ptr(t_rhs, m_rhs), 0, N - 1), 0)
    return Tree(
        kind.to(torch.int32), op.to(torch.int32), lhs.to(torch.int32),
        rhs.to(torch.int32), feat.to(torch.int32), val, new_len[:, 0].to(torch.int32),
    )


def _randint(gen, n: torch.Tensor | int, shape, device) -> torch.Tensor:
    """Uniform integers in [0, max(n, 1)) from one uniform draw per entry
    (per-lane bounds; no host round trip)."""
    u = torch.rand(shape, generator=gen, device=device)
    if isinstance(n, int):  # a Python bound: no host-to-device copy
        n = max(n, 1)
        return torch.clamp_max((u * n).to(torch.int32), n - 1)
    n = torch.clamp_min(n, 1)
    return torch.minimum((u * n).to(torch.int32), (n - 1).to(torch.int32))


def random_tree(
    gen: torch.Generator,
    m: torch.Tensor,
    n_slots: int,
    nfeatures: int,
    n_unary: int,
    n_binary: int,
    dtype=torch.float32,
) -> Tree:
    """A random postorder tree per lane with exactly ``m[l]`` nodes (m
    clamped to [1, n_slots], one less when no unary operators exist and m
    is even). Leaves are 50/50 constant (standard normal) / feature, as in
    the JAX package: draw an arity multiset, shuffle it, and rotate it so
    its Łukasiewicz path stays positive (the cycle lemma)."""
    device = m.device
    L, N = m.shape[0], n_slots
    m = torch.clamp(m.to(torch.int32), 1, N)
    if n_binary == 0:
        b = torch.zeros_like(m)
        if n_unary == 0:
            m = torch.ones_like(m)
    elif n_unary == 0:
        m = torch.where(m % 2 == 0, torch.clamp_min(m - 1, 1), m)
        b = (m - 1) // 2
    else:
        b = _randint(gen, (m - 1) // 2 + 1, (L,), device)
    u = m - 1 - 2 * b
    j = torch.arange(N, device=device, dtype=torch.int32)[None, :]
    live = j < m[:, None]
    arity = torch.where(j < b[:, None], 2, torch.where(j < (b + u)[:, None], 1, 0))
    keys = torch.where(live, torch.rand((L, N), generator=gen, device=device), torch.inf)
    perm = torch.argsort(keys, dim=1, stable=True)
    arity = torch.where(live, torch.gather(arity, 1, perm), 0)
    # rotate to start just after the last minimum of the prefix sums
    prefix = torch.cumsum(torch.where(live, 1 - arity, 0), 1, dtype=torch.int32)
    masked = torch.where(live, prefix, torch.iinfo(torch.int32).max)
    minval = torch.amin(masked, dim=1, keepdim=True)
    r = torch.amax(torch.where(masked == minval, j, -1), dim=1, keepdim=True)
    rot = torch.where(live, (r + 1 + j) % torch.clamp_min(m[:, None], 1), 0)
    arity = torch.where(live, torch.gather(arity, 1, rot.long()), 0).to(torch.int32)

    is_bin = arity == 2
    is_un = arity == 1
    is_leaf = live & (arity == 0)
    const_mask = torch.rand((L, N), generator=gen, device=device) < 0.5
    if nfeatures <= 0:
        const_mask = torch.ones_like(const_mask)
    kind = torch.where(
        is_bin, KIND_BINARY,
        torch.where(is_un, KIND_UNARY, torch.where(is_leaf & const_mask, KIND_CONST, KIND_VAR)),
    )
    kind = torch.where(live, kind, KIND_PAD).to(torch.int32)
    # canonical form (unlike the JAX package's draw): payloads only where
    # the slot's kind reads them, zeros elsewhere
    op = torch.where(
        is_bin,
        _randint(gen, n_binary, (L, N), device),
        torch.where(is_un, _randint(gen, n_unary, (L, N), device), 0),
    ).to(torch.int32)
    feat = torch.where(kind == KIND_VAR, _randint(gen, nfeatures, (L, N), device), 0)
    val = torch.randn((L, N), generator=gen, device=device, dtype=dtype)
    val = torch.where(kind == KIND_CONST, val, torch.zeros_like(val))
    # child pointers: the right (or only) child is the previous slot; a
    # binary node's left child ends just before its right child's subtree
    sizes = _sizes_from_arity(arity, live)
    prev = torch.clamp_min(j - 1, 0).expand(L, N)
    prev_size = torch.gather(sizes, 1, prev.long())
    lhs = torch.where(is_bin, j - 1 - prev_size, torch.where(is_un, j - 1, 0))
    rhs = torch.where(is_bin, j - 1, 0)
    return Tree(
        kind, op, lhs.to(torch.int32), rhs.to(torch.int32), feat, val,
        m.to(torch.int32),
    )
