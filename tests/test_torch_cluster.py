"""``vipers_torch cluster`` against ``vipers cluster`` on the CPU: the
same pseudo-label pickle byte for byte, from one DINO ``.pth``, once the
port's k-means starts from the JAX package's own draw of initial points
(patched in here: the draw is the one difference between the packages);
``whiten``, ``cluster_input`` and ``kmeans2_init`` against the JAX
functions; the flags; the card by default.

``dino_vit_tiny`` at the registry's width and depth (the weights of
``tests/test_torch_dino_cli.py``), f32, 256x256 crops of seeded boxes on
``tests/test_torch_dino_cli.py``'s synthetic VOC07 images.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vipers.discovery.cluster as jcluster
import vipers.discovery.kmeans as jkmeans
from tests import torch_explain_fixtures as fx
from tests.test_torch_dino_cli import _voc, weights  # noqa: F401  (a fixture)
from vipers.cli.main import main as jmain
from vipers_torch.cli.main import build_parser
from vipers_torch.cli.main import main as tmain
from vipers_torch.discovery import cluster as tcluster
from vipers_torch.discovery import kmeans as tkmeans


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    yield from fx.one_torch_thread()


def _jax_initial_points(n, k, seed):
    return torch.from_numpy(np.array(jax.random.permutation(jax.random.PRNGKey(seed), n)[:k]))


def test_cluster_cli_matches_jax(weights, tmp_path, monkeypatch):
    """12 seeded boxes on 12 images, ``dino_vit_tiny`` from the ``.pth``, 3
    clusters: the port's pickle byte-equal to ``vipers cluster``'s, and
    the feature cache the same embeddings (1e-5 of their scale)."""
    monkeypatch.setattr(tkmeans, "initial_points", _jax_initial_points)
    data = _voc(tmp_path / "voc", 12)
    rng = np.random.default_rng(4)
    preds = {}
    for i in range(12):
        x1, y1 = rng.uniform(0, 60, 2)
        preds[f"im{i:03d}.jpg"] = np.array([x1, y1, x1 + rng.uniform(8, 60),
                                            y1 + rng.uniform(8, 40)])
    out = {}
    for pkg, main in (("port", tmain), ("jax", jmain)):
        os.makedirs(tmp_path / pkg)
        with open(tmp_path / pkg / "preds.pkl", "wb") as f:
            pickle.dump(preds, f)
        argv = ["cluster", "--preds", str(tmp_path / pkg / "preds.pkl"), "--data-path", data,
                "--arch", "dino_vit_tiny", "--checkpoint", weights["dino"],
                "--nb-clusters", "3", "--random-seed", "5",
                "--feature-cache", str(tmp_path / pkg / "feats.pkl")]
        assert main(argv + (["--device", "cpu"] if pkg == "port" else [])) in (0, None)
        out[pkg] = (tmp_path / pkg / "preds_clusters_3.pkl").read_bytes()
        with open(tmp_path / pkg / "feats.pkl", "rb") as f:
            out[pkg + "_feats"] = np.asarray(pickle.load(f))
    want = out["jax_feats"]
    np.testing.assert_allclose(out["port_feats"], want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert out["port"] == out["jax"]
    labels = pickle.loads(out["port"])
    assert sorted(labels) == sorted(preds) and len(set(labels.values())) > 1
    # a second run reads the cache and gives the same labels
    assert tmain(["cluster", "--preds", str(tmp_path / "port" / "preds.pkl"), "--data-path",
                  data, "--arch", "dino_vit_tiny", "--nb-clusters", "3", "--random-seed", "5",
                  "--feature-cache", str(tmp_path / "port" / "feats.pkl"),
                  "--device", "cpu"]) == 0
    assert (tmp_path / "port" / "preds_clusters_3.pkl").read_bytes() == out["port"]


def test_kmeans_pieces_match_jax():
    """``whiten``, ``cluster_input`` and ``kmeans2_init`` (from the same
    initial centroids, an empty cluster among them) on seeded data."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(c, 0.3, size=(20, 6)) for c in (-2, 0, 2)]).astype(np.float32)
    np.testing.assert_allclose(tkmeans.whiten(torch.from_numpy(x)).numpy(),
                               np.asarray(jkmeans.whiten(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    white = tcluster.cluster_input(torch.from_numpy(x))
    np.testing.assert_allclose(white.numpy(), np.asarray(jcluster.cluster_input(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    init = np.concatenate([x[[0, 25, 59]], np.full((1, 6), 50.0, np.float32)])  # 4th: empty
    for iters in (1, 3, 10):
        tc, tl = tkmeans.kmeans2_init(white, torch.from_numpy(init), iters=iters)
        jc, jl = jkmeans.kmeans2_init(jnp.asarray(white.numpy()), jnp.asarray(init), iters=iters)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
        assert np.array_equal(tc.numpy()[3], init[3])  # the empty cluster kept its centroid
    with pytest.raises(ValueError, match="iters"):
        tkmeans.kmeans2_init(white, torch.from_numpy(init), iters=0)
    idx = tkmeans.initial_points(60, 5, 3)
    assert len(set(idx.tolist())) == 5 and torch.equal(idx, tkmeans.initial_points(60, 5, 3))


def test_cluster_namespace_matches_vipers_cli():
    """``cluster``'s flags are ``vipers cluster``'s plus ``--device``, with
    the same defaults."""
    import inspect
    import re

    import vipers.cli.main as jcli

    src = inspect.getsource(jcli.main)
    block = src[src.index('clus = sub.add_parser("cluster"'):src.index('mvh = sub.add_parser')]
    jflags = set(re.findall(r'clus\.add_argument\("(--[a-z0-9-]+)"', block))
    ns = vars(build_parser().parse_args(["cluster", "--preds", "p.pkl"]))
    assert {"--" + k.replace("_", "-") for k in ns} - {"--cmd"} == jflags | {"--device"}
    assert (ns["nb_clusters"], ns["arch"], ns["patch_size"], ns["random_seed"],
            ns["dataset"], ns["set"], ns["device"]) == (20, "dino_vit_small", 16, 0,
                                                        "VOC07", "trainval", "cuda")


def test_cluster_needs_the_card_unless_asked(tmp_path):
    """Without ``--device cpu`` on a host with no card, ``cluster`` raises
    before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with open(tmp_path / "preds.pkl", "wb") as f:
        pickle.dump({"im000.jpg": np.zeros(4)}, f)
    with pytest.raises(RuntimeError, match="cpu"):
        tmain(["cluster", "--preds", str(tmp_path / "preds.pkl"), "--data-path",
               _voc(tmp_path / "voc", 1)])
    assert not (tmp_path / "preds_clusters_20.pkl").exists()
