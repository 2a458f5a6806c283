"""The measured maxima of the comparisons in tests/test_torch_mmgcn.py.

The tests assert each comparison against its tolerance; this script runs
the same inputs through JAX and the port on the CPU and prints how close
they came: the largest absolute difference of values, and of gradients the
largest ‖got − want‖ / ‖want‖ over the tensors compared.

    JAX_PLATFORMS=cpu python scripts/torch_mmgcn_parity.py
"""

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_mmgcn as t  # noqa: E402
from erc_tpu.models import mmgcn as jmmgcn  # noqa: E402
from erc_tpu.ops import gnn as jgnn  # noqa: E402
from erc_tpu.ops import graphs as jgraphs  # noqa: E402
from erc_tpu_torch import convert  # noqa: E402
from erc_tpu_torch.ops import gnn as tgnn  # noqa: E402
from erc_tpu_torch.ops import graphs as tgraphs  # noqa: E402
from erc_tpu_torch.train.trainer import masked_cross_entropy  # noqa: E402


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _abs(got, want):
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())


def adjacency():
    feats, valid = t._feats()
    jv, tv = jnp.asarray(valid), torch.from_numpy(valid)
    rows = []
    for name, jf, tf in (
            ("mmgcn_big_adjacency", lambda *f: jgraphs.mmgcn_big_adjacency(list(f), jv),
             lambda *f: tgraphs.mmgcn_big_adjacency(list(f), tv)),
            ("mmgcn_structured_adjacency", lambda *f: jgraphs.mmgcn_structured_adjacency(list(f), jv),
             lambda *f: tgraphs.mmgcn_structured_adjacency(list(f), tv))):
        want, cots, grads = t._jax_vjp(jf, *feats)
        outs, tgrads = t._torch_vjp(tf, cots, *feats)
        wants = want if isinstance(want, tuple) else (want,)
        rows.append((name, max(_abs(o, w) for o, w in zip(outs, wants)),
                     max(_rel(a, b) for a, b in zip(tgrads, grads))))
    return rows


def stacks():
    rows = []
    for form, nlayers, chunk in t.STACKS:
        x, adj = t._stack_inputs(form)
        for remat in t.REMATS:
            jcls = jgnn.GCNIIStackStructured if form == "structured" else jgnn.GCNIIStack
            jm = jcls(nlayers=nlayers, nhidden=8, remat=remat, chunk=chunk)
            params = t._np_tree(jm.init(jax.random.PRNGKey(0), x, *adj))["params"]
            want, cots, grads = t._jax_vjp(lambda p, xx, *a: jm.apply({"params": p}, xx, *a), params, x, *adj)
            module = (tgnn.GCNIIStackStructured if form == "structured" else tgnn.GCNIIStack)(
                nlayers, 8, remat=remat, chunk=chunk)

            def run(convs, xx, *a):
                return torch.func.functional_call(module, {"convs": convs}, (xx, *a))

            (got,), tgrads = t._torch_vjp(run, cots, params["convs"], x, *adj)
            rel = max([_rel(tgrads[0], grads[0]["convs"])] + [_rel(a, b) for a, b in zip(tgrads[1:], grads[1:])])
            rows.append((f"GCNIIStack {form} {remat}", _abs(got, want), rel))
    return rows


def modules():
    rows = []
    for lstm_mode, modals, n_speakers in t.CASES:
        batch = t._batch(modals, n_speakers)
        kw = t._kw(modals, n_speakers, lstm_mode)
        params = t._np_tree(jmmgcn.MMGCNModule(adj_impl="dense", **kw).init(jax.random.PRNGKey(0), batch))["params"]
        for impl in ("dense", "structured"):
            model = jmmgcn.MMGCNModule(adj_impl=impl, **kw)
            with jax.default_matmul_precision("highest"):
                (loss, logits), grads = jax.jit(jax.value_and_grad(t._jax_loss(model, batch), has_aux=True))(params)
            module = t._port_module(modals, n_speakers, lstm_mode, impl)
            module.load_state_dict(convert.mmgcn_state(params))
            tb = t._t(batch)
            with torch.enable_grad():
                out = module(tb)
                masked_cross_entropy(out, tb["label"], tb["attention_mask"]).backward()
            want = convert.mmgcn_state(t._np_tree(grads))
            rel = max(_rel(p.grad.numpy(), want[n].numpy()) for n, p in module.named_parameters()
                      if float(want[n].norm()) > 0)
            rows.append((f"MMGCNModule {lstm_mode} {modals} s{n_speakers} {impl}",
                         _abs(out.detach().numpy(), logits), rel))
    return rows


def main():
    print(f"{'comparison':<48} {'max abs diff':>14} {'max grad rel':>14}")
    for name, a, r in adjacency() + stacks() + modules():
        print(f"{name:<48} {a:14.3e} {r:14.3e}")


if __name__ == "__main__":
    main()
