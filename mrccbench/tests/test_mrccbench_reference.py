"""The plain reference against hand-built sparse convs and steps on small
clouds (CPU): voxels, levels and maps against Python sets, the convs and
their gradients against dense brute force, AdamW against torch's."""

import itertools

import numpy as np
import pytest
import torch

from mrccbench.reference import minkunet, nn as rnn, sparse, train

torch.set_num_threads(1)


def _cloud(seed, b=2, p=400, span=0.06, size=0.01):
    g = np.random.default_rng(seed)
    pts = g.uniform(-span, span, (b, p, 3)).astype(np.float32)
    mask = g.random((b, p)) < 0.9
    feats = g.normal(size=(b, p, 3)).astype(np.float32)
    labels = g.integers(0, 3, (b, p)).astype(np.int32)
    return pts, feats, mask, labels, size


def _brute_voxels(pts, feats, mask, labels, size, cap):
    """{(item, x, y, z): (mean feats, label)} of the ``cap`` smallest keys
    per item."""
    out = {}
    for i in range(pts.shape[0]):
        cells = {}
        for p, f, m, lab in zip(pts[i], feats[i], mask[i], labels[i]):
            if not m:
                continue
            q = torch.tensor(p) / torch.tensor(size, dtype=torch.float32)
            c = tuple(int(v) + 512 for v in torch.floor(q).tolist())
            cells.setdefault(c, []).append((f, lab))
        for c in sorted(cells)[:cap]:
            fs = np.array([f for f, _ in cells[c]], np.float64)
            labs = {lab for _, lab in cells[c]}
            out[(i,) + c] = (fs.mean(0), labs.pop() if len(labs) == 1
                             else -100)
    return out


@pytest.mark.parametrize("cap", [10_000, 37])
def test_voxelize_against_brute_force(cap):
    pts, feats, mask, labels, size = _cloud(1)
    level, vf, vl = sparse.voxelize(*map(torch.as_tensor,
                                         (pts, feats, mask, labels)),
                                    size, cap)
    want = _brute_voxels(pts, feats, mask, labels, size, cap)
    got_keys = [(int(it),) + tuple(int(v) for v in o)
                for it, o in zip(level.item, level.off)]
    assert got_keys == sorted(want)
    for k, f, lab in zip(got_keys, vf, vl):
        np.testing.assert_allclose(f.numpy(), want[k][0], rtol=1e-6,
                                   atol=1e-7)
        assert int(lab) == want[k][1]
    assert level.count.tolist() == [sum(1 for k in want if k[0] == i)
                                    for i in range(2)]


def _levels(seed=2, caps=(40, 30, 20, 10)):
    pts, feats, mask, labels, size = _cloud(seed)
    t = [torch.as_tensor(x) for x in (pts, feats, mask, labels)]
    level0, vf, vl = sparse.voxelize(*t, size, 10_000)
    levels, octs = sparse.hierarchy(level0, caps, 2)
    return levels, octs, vf


def _coords(level):
    return [(int(i),) + tuple(int(v) for v in o)
            for i, o in zip(level.item, level.off)]


def test_levels_and_maps_against_sets():
    caps = (40, 30, 20, 10)
    levels, octs, _ = _levels(caps=caps)
    for fine, coarse, maps, cap in zip(levels, levels[1:], octs, caps):
        fc, cc = _coords(fine), _coords(coarse)
        want = []
        for i in (0, 1):
            want += sorted({(i,) + tuple(v // 2 for v in c[1:])
                            for c in fc if c[0] == i})[:cap]
        assert cc == want
        index = {c: j for j, c in enumerate(cc)}
        linked = set()
        for o, (rows, par) in enumerate(maps):
            for r, p in zip(rows.tolist(), par.tolist()):
                c = fc[r]
                assert (c[1] % 2) * 4 + (c[2] % 2) * 2 + c[3] % 2 == o
                assert index[(c[0],) + tuple(v // 2 for v in c[1:])] == p
                linked.add(r)
        assert linked == {r for r, c in enumerate(fc)
                          if (c[0],) + tuple(v // 2 for v in c[1:]) in index}
    for lv in levels:
        cs = _coords(lv)
        index = {c: j for j, c in enumerate(cs)}
        for k, (rows, src) in enumerate(lv.k3):
            d = sparse.K3_OFFSETS[k]
            want = {(r, index[(c[0], c[1] + d[0], c[2] + d[1], c[3] + d[2])])
                    for r, c in enumerate(cs)
                    if (c[0], c[1] + d[0], c[2] + d[1], c[3] + d[2]) in index}
            assert set(zip(rows.tolist(), src.tolist())) == want


def _dense_k3(x, w, level):
    cs = _coords(level)
    index = {c: j for j, c in enumerate(cs)}
    out = []
    for c in cs:
        acc = torch.zeros(w.shape[-1], dtype=x.dtype)
        for k, d in enumerate(sparse.K3_OFFSETS):
            j = index.get((c[0], c[1] + d[0], c[2] + d[1], c[3] + d[2]))
            if j is not None:
                acc = acc + x[j] @ w[k]
        out.append(acc)
    return torch.stack(out)


def _dense_down(x, w, fine, coarse):
    fc, cc = _coords(fine), _coords(coarse)
    index = {c: j for j, c in enumerate(cc)}
    out = [torch.zeros(w.shape[-1], dtype=x.dtype) for _ in cc]
    for r, c in enumerate(fc):
        p = index.get((c[0],) + tuple(v // 2 for v in c[1:]))
        if p is not None:
            o = (c[1] % 2) * 4 + (c[2] % 2) * 2 + c[3] % 2
            out[p] = out[p] + x[r] @ w[o]
    return torch.stack(out)


def _dense_up(x, w, coarse, fine):
    fc, cc = _coords(fine), _coords(coarse)
    index = {c: j for j, c in enumerate(cc)}
    out = []
    for c in fc:
        p = index.get((c[0],) + tuple(v // 2 for v in c[1:]))
        o = (c[1] % 2) * 4 + (c[2] % 2) * 2 + c[3] % 2
        out.append(x[p] @ w[o] if p is not None
                   else torch.zeros(w.shape[-1], dtype=x.dtype))
    return torch.stack(out)


@pytest.mark.parametrize("kind", ["k3", "down", "up"])
def test_convs_and_gradients_against_dense(kind):
    levels, octs, _ = _levels()
    g = torch.Generator().manual_seed(3)
    prec = rnn.Precision()
    if kind == "k3":
        lv = levels[1]
        x = torch.randn(lv.rows, 5, generator=g, dtype=torch.float64)
        w = torch.randn(27, 5, 4, generator=g, dtype=torch.float64)
        fn = (lambda x, w: rnn.conv_k3(x, w, lv, prec),
              lambda x, w: _dense_k3(x, w, lv))
    elif kind == "down":
        x = torch.randn(levels[0].rows, 5, generator=g, dtype=torch.float64)
        w = torch.randn(8, 5, 4, generator=g, dtype=torch.float64)
        fn = (lambda x, w: rnn.conv_down(x, w, octs[0], levels[1], prec),
              lambda x, w: _dense_down(x, w, levels[0], levels[1]))
    else:
        x = torch.randn(levels[2].rows, 5, generator=g, dtype=torch.float64)
        w = torch.randn(8, 5, 4, generator=g, dtype=torch.float64)
        fn = (lambda x, w: rnn.conv_up(x, w, octs[1], levels[1], prec),
              lambda x, w: _dense_up(x, w, levels[2], levels[1]))
    x.requires_grad_(True)
    w.requires_grad_(True)
    got, want = fn[0](x, w), fn[1](x, w)
    torch.testing.assert_close(got, want)
    dy = torch.randn(got.shape, generator=g, dtype=torch.float64)
    gx, gw = torch.autograd.grad(got, (x, w), dy)
    wx, ww = torch.autograd.grad(want, (x, w), dy)
    torch.testing.assert_close(gx, wx)
    torch.testing.assert_close(gw, ww)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -(1.0 + 2 ** -11), 3.0e-39])
    got = rnn.round_tf32(x)
    assert got.tolist()[:4] == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0,
                                -(1.0 + 2 ** -10)]
    bits = got.view(torch.int32) & ((1 << 13) - 1)
    assert int(bits.abs().sum()) == 0


CFG = {"backbone": "minkunet14A", "in_channels": 3, "num_classes": 3,
       "unet_out_channels": 16, "head_width": 24, "voxel_size": 0.02,
       "ignore_label": -100,
       "optimizer": {"lr": 1e-3, "weight_decay": 1e-2,
                     "betas": [0.9, 0.999], "eps": 1e-8}}


def _batch(seed):
    pts, feats, mask, labels, _ = _cloud(seed, p=600, span=0.3)
    return {"points": pts, "feats": feats, "mask": mask, "labels": labels}


def test_parameter_spec_names_and_shapes():
    spec = minkunet.parameter_spec(dict(CFG, backbone="minkunet18D",
                                        unet_out_channels=256,
                                        head_width=1024))
    names = [n for n, _, _ in spec]
    assert len(names) == len(set(names)) == 150
    shapes = dict((n, s) for n, s, _ in spec)
    assert shapes["conv0p1s1.kernel"] == (27, 3, 32)
    assert shapes["block5.0.conv1.kernel"] == (27, 512, 384)
    assert shapes["block5.0.downsample.0.kernel"] == (1, 512, 384)
    assert shapes["convtr7p2s2.kernel"] == (8, 384, 384)
    assert shapes["final.kernel"] == (1, 384, 256)
    assert shapes["regression.2.linear.weight"] == (3, 1024)
    assert sum(int(np.prod(s)) for s in shapes.values()) == 80_222_179


def test_weights_depend_on_the_seed_only():
    a = minkunet.make_weights(CFG, 2 ** 31 + 11, "cpu")
    b = minkunet.make_weights(CFG, 2 ** 31 + 11, "cpu")
    c = minkunet.make_weights(CFG, 2 ** 31 + 12, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv0p1s1.kernel"], c["conv0p1s1.kernel"])
    assert float(a["bn0.bn.weight"].min()) == 1.0


def test_reference_step_is_adamw_on_its_own_gradients():
    weights = minkunet.make_weights(CFG, 5, "cpu")
    mix = {"voxel_capacity": 512}
    ref = train.ReferenceTrainer(CFG, mix, weights)
    params = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    opt = torch.optim.AdamW(list(params.values()), lr=1e-3, eps=1e-8,
                            betas=(0.9, 0.999), weight_decay=1e-2)
    for seed in (7, 8):
        batch = _batch(seed)
        loss, grads = ref.step(batch)
        levels, octs, feats, labels = train.prepare(CFG, mix, batch, "cpu")
        logits = minkunet.forward(params, feats, levels, octs,
                                  rnn.Precision())
        want = rnn.cross_entropy(logits, labels)
        opt.zero_grad()
        want.backward()
        opt.step()
        assert loss == pytest.approx(float(want.detach()), rel=1e-6)
        for k in params:
            torch.testing.assert_close(grads[k], params[k].grad)
            torch.testing.assert_close(ref.params[k].detach(),
                                       params[k].detach(), rtol=1e-6,
                                       atol=1e-7)


def test_compare_takes_the_worst_leaf_against_the_median():
    ref = {"losses": [1.0, 0.5], "grad": {"a": 1.0, "b": 2.0, "c": 1e-9},
           "change": {"a": 1.0, "b": 1.0, "c": 0.5}}
    prog = {"losses": [1.0, 0.51], "grad": {"a": 1.0, "b": 2.2, "c": 0.15},
            "change": {"a": 1.0, "b": 1.0, "c": 0.0}}
    got = train.compare(prog, ref)
    assert got["loss"] == (pytest.approx(0.02), "step 2")
    assert got["grad"][0] == pytest.approx(0.15)  # c: 0.15 / median 1.0
    assert got["grad"][1] == "c"
    assert got["grad_median"][0] == pytest.approx(0.1)  # b: 0.2 / 2.0
    # c's gradient is nought to rounding: its change is not compared
    assert got["change"][0] == 0.0


def test_cross_entropy_ignores_labels():
    logits = torch.tensor([[2.0, 0.0], [0.0, 1.0], [5.0, 5.0]])
    labels = torch.tensor([0, 1, -100])
    want = -(torch.log_softmax(logits[:2], -1)[[0, 1], [0, 1]]).mean()
    assert float(rnn.cross_entropy(logits, labels)) == pytest.approx(
        float(want))


def test_brute_force_helpers_see_every_offset():
    assert len(set(itertools.product((-1, 0, 1), repeat=3))) == len(
        sparse.K3_OFFSETS)
    assert sparse.K3_OFFSETS[13] == (0, 0, 0)
