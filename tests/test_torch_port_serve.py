"""alignn_tpu_torch's inference server (``cli/serve.py``) against
alignn_tpu's, on the CPU.

Both servers run on ephemeral localhost ports over one small model
directory (the 1+1/32 BatchNorm property model, its running statistics
moved off their start, written by the port and read by both packages).
The same requests, ``/health``, a single and a batch ``/predict``, the
``/ff`` guard, a malformed request and an unknown path, get the same
codes; the predictions agree within 1e-5.  The port's compiled forward
keeps one signature per bucket floor, which only grows.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
from torch_port_threads import _two_threads  # noqa: E402,F401

MODEL = {"name": "alignn", "alignn_layers": 1, "gcn_layers": 1,
         "hidden_features": 32, "embedding_features": 16}


def _atoms(a=4.0, shift=0.0):
    return {"lattice_mat": (np.eye(3) * a).tolist(),
            "coords": [[0, 0, 0], [0.5 + shift, 0.5, 0.5]],
            "elements": ["Na", "Cl"]}


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """{"port": url, "jax": url} and the port's service."""
    import torch

    from alignn_tpu.cli.serve import serve as jserve
    from alignn_tpu_torch.cli.serve import serve
    from alignn_tpu_torch.config import model_config_from_dict
    from alignn_tpu_torch.nn.convert import flax_from_module
    from alignn_tpu_torch.nn.models import ALIGNN, init_parameters
    from alignn_tpu_torch.train.checkpoint import checkpoint_meta, \
        save_params

    model_dir = tmp_path_factory.mktemp("model")
    model = init_parameters(ALIGNN(model_config_from_dict(MODEL)),
                            torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    for name, buf in model.named_buffers():   # running statistics
        buf.copy_(0.1 * torch.randn(buf.shape, generator=gen)
                  + (1.0 if name.endswith("var") else 0.0))
    save_params(str(model_dir / "best_model.mpk"), *flax_from_module(model),
                meta=checkpoint_meta())
    (model_dir / "config.json").write_text(json.dumps(
        {"atom_features": "cgcnn", "model": MODEL}))
    started = {}
    for name, make in (("jax", lambda: jserve(str(model_dir), port=0)),
                       ("port", lambda: serve(str(model_dir), port=0,
                                              device="cpu"))):
        srv, service = make()
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        started[name] = (srv, service,
                         f"http://127.0.0.1:{srv.server_address[1]}")
    yield {k: v[2] for k, v in started.items()}, started["port"][1]
    for srv, _s, _u in started.values():
        srv.shutdown()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


REQUESTS = {
    "single": {"atoms": _atoms()},
    "batch": {"atoms_list": [_atoms(4.0), _atoms(4.2, 0.01),
                             _atoms(4.4, -0.02)]},
    "single_again": {"atoms": _atoms(4.1, 0.02)},
}


def test_health_and_errors_match_jax(servers):
    """/health, the /ff guard, a malformed /predict and unknown paths:
    the same codes and the same keys as JAX's server."""
    urls, _service = servers
    answers = {}
    for name, url in urls.items():
        answers[name] = [
            _get(url + "/health"), _get(url + "/nope"),
            _post(url + "/ff", {"atoms": _atoms()}),
            _post(url + "/predict", {"bogus": 1}),
            _post(url + "/nope", {})]
    port, ref = answers["port"], answers["jax"]
    assert [c for c, _ in port] == [c for c, _ in ref] == \
        [200, 404, 400, 400, 404]
    assert port[0][1]["status"] == "ok" and port[0][1]["ff"] is False
    assert "without --ff" in port[2][1]["error"]
    assert port[3][1]["error"] == ref[3][1]["error"]
    for (_c, got), (_r, exp) in zip(port, ref):
        assert set(got) == set(exp)


def test_predictions_match_jax(servers):
    """Single and batch /predict within 1e-5 of JAX's server; the port's
    bucket floor only grows and its compiled forward holds one loop per
    signature."""
    urls, service = servers
    for name, payload in REQUESTS.items():
        code, got = _post(urls["port"] + "/predict", payload)
        jcode, ref = _post(urls["jax"] + "/predict", payload)
        assert code == jcode == 200, name
        assert np.asarray(got["predictions"]).shape == \
            np.asarray(ref["predictions"]).shape
        np.testing.assert_allclose(got["predictions"], ref["predictions"],
                                   rtol=0, atol=1e-5, err_msg=name)
    # the warm-up's bucket, then the batch's, which the third request
    # reuses: two signatures
    assert len(service.forward.loops) == 2
    assert service._spec.n_graphs == 4
