"""The port's serving entry point with ``mesh_tensor: 2`` on the CPU:
``serve/api.main`` (through ``tests/tp_ranks.py serve``, which asks for
gloo) starts its follower rank itself and answers over HTTP.

- One completion and one SSE stream equal the unsharded server's on the
  same weights (the same params.json without the mesh, served in this
  process by ``create_server``).
- SIGTERM to rank 0 drains, stops the follower and exits 0, and no rank
  survives; a killed follower ends rank 0 with a non-zero code within
  ``KILL_BOUND_S``.
- With the default backend (NCCL, one GPU per rank) ``mesh_tensor: 2``
  on a machine with fewer GPUs raises naming the device count; the axes
  and features the tensor-parallel server does not take are refused by
  name before any rank starts; the example servers' ``collective_matmul:
  auto`` passes and its resolution is logged.
"""

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from runbooks_tpu_torch.serve import api

ROOT = Path(__file__).resolve().parents[1]
MODEL = {"model": "debug",
         "model_overrides": {"vocab_size": 512, "hidden_size": 64,
                             "intermediate_size": 128, "num_heads": 4,
                             "num_kv_heads": 2, "head_dim": 16,
                             "max_seq_len": 64, "dtype": "float32"},
         "seed": 3, "max_slots": 2}
# How long rank 0 may outlive a killed follower (its guard polls every
# 0.2 s; gloo fails a collective with a dead peer at once).
KILL_BOUND_S = 10.0
START_TIMEOUT_S = 90.0

BODY = {"prompt": "tensor parallel", "max_tokens": 8, "temperature": 0.0}


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/v1/completions", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read().decode()
    conn.close()
    return resp.status, raw


def _answers(port):
    """(completion text, finish reason, usage) and the SSE stream's
    concatenated text and last finish reason."""
    status, raw = _post(port, BODY)
    assert status == 200, raw
    plain = json.loads(raw)
    status, raw = _post(port, dict(BODY, stream=True))
    assert status == 200, raw
    events = [json.loads(line[len("data: "):]) for line in raw.splitlines()
              if line.startswith("data: ") and line != "data: [DONE]"]
    assert raw.rstrip().endswith("data: [DONE]")
    return ((plain["choices"][0]["text"],
             plain["choices"][0]["finish_reason"], plain["usage"]),
            ("".join(e["choices"][0]["text"] for e in events),
             events[-1]["choices"][0]["finish_reason"]))


class TPServer:
    """``serve/api.main`` over gloo as a subprocess: rank 0's pid, its
    follower's, and the port it announced."""

    def __init__(self, tmp_path: Path, **extra):
        content = tmp_path / "content"
        content.mkdir()
        (content / "params.json").write_text(json.dumps(
            dict(MODEL, mesh_tensor=2, port=0, **extra)))
        env = dict(os.environ, RBT_CONTENT_DIR=str(content))
        self.log = tmp_path / "server.log"
        self.proc = subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "tp_ranks.py"), "serve"],
            env=env, stdout=open(self.log, "w"), stderr=subprocess.STDOUT,
            cwd=str(tmp_path))
        self.followers = []
        try:
            deadline = time.monotonic() + START_TIMEOUT_S
            self.port = None
            while self.port is None:
                assert self.proc.poll() is None, self.log.read_text()
                assert time.monotonic() < deadline, self.log.read_text()
                for line in self.log.read_text().splitlines():
                    if " ready on port " in line:
                        self.port = int(line.rsplit(" ", 1)[1])
                time.sleep(0.1)
            # The spawned rank (not multiprocessing's resource tracker).
            self.followers = [p for p in _children(self.proc.pid)
                              if "spawn_main" in _cmdline(p)]
            assert len(self.followers) == 1, self.followers
        except BaseException:
            self.followers = _children(self.proc.pid)
            self.close()
            raise

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(10)
        for pid in self.followers:
            if _alive(pid):
                os.kill(pid, signal.SIGKILL)


def _children(pid):
    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                stat = Path(f"/proc/{d}/stat").read_text()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                out.append(int(d))
    return out


def _cmdline(pid) -> str:
    try:
        return Path(f"/proc/{pid}/cmdline").read_text().replace("\0", " ")
    except OSError:
        return ""


def _alive(pid) -> bool:
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1]
    except OSError:
        return False
    return state.split()[0] != "Z"


def _unsharded(tmp_path):
    params = dict(MODEL)
    cfg, p = api.load_model(params, device="cpu")
    srv = api.create_server(cfg, p, host="127.0.0.1", port=0, device="cpu",
                            max_slots=2)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        return _answers(srv.port)
    finally:
        srv.shutdown()
        t.join(10)


def test_main_mesh_tensor_2_serves_like_one_device_and_exits_0(tmp_path):
    srv = TPServer(tmp_path)
    try:
        got = _answers(srv.port)
        assert got == _unsharded(tmp_path)
        srv.proc.send_signal(signal.SIGTERM)
        assert srv.proc.wait(60) == 0, srv.log.read_text()
        log = srv.log.read_text()
        stopped = json.loads(next(line for line in log.splitlines()
                                  if line.startswith('{"stopped"')))
        assert stopped["ranks"] == 2
        assert stopped["follower_exit_codes"] == [0]
        deadline = time.monotonic() + 10
        while any(_alive(p) for p in srv.followers) \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not any(_alive(p) for p in srv.followers)
    finally:
        srv.close()


def test_killed_follower_ends_rank_0_non_zero(tmp_path):
    srv = TPServer(tmp_path)
    try:
        t0 = time.monotonic()
        os.kill(srv.followers[0], signal.SIGKILL)
        code = srv.proc.wait(KILL_BOUND_S + 30)
        assert time.monotonic() - t0 < KILL_BOUND_S
        assert code != 0
        assert "exited with code -9" in srv.log.read_text()
    finally:
        srv.close()


def _main_with(tmp_path, monkeypatch, params, **kw):
    (tmp_path / "params.json").write_text(json.dumps(dict(MODEL, **params)))
    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path))
    return api.main(**kw)


def test_main_mesh_tensor_beyond_the_gpus_raises_naming_the_count(
        tmp_path, monkeypatch):
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
    with pytest.raises(RuntimeError,
                       match=r"mesh_tensor=2 needs 2 GPUs .* "
                             r"torch.cuda.device_count\(\) is 1"):
        _main_with(tmp_path, monkeypatch, {"mesh_tensor": 2})
    with pytest.raises(RuntimeError,
                       match=r"mesh_expert=2, mesh_tensor=2 needs 4 GPUs .* "
                             r"torch.cuda.device_count\(\) is 1"):
        _main_with(tmp_path, monkeypatch, {"mesh_expert": 2,
                                           "mesh_tensor": 2})


def test_main_takes_the_mixtral_examples_expert_mesh(tmp_path, monkeypatch):
    """examples/mixtral-8x7b/server.yaml (mesh_expert 2 x mesh_tensor 2)
    passes main's parse: a replica of four ranks (started, stubbed: it
    needs four GPUs)."""
    import yaml

    spec = yaml.safe_load((ROOT / "examples" / "mixtral-8x7b" /
                           "server.yaml").read_text())
    params = spec["spec"]["params"]
    assert (params["mesh_expert"], params["mesh_tensor"]) == (2, 2)
    started = []
    monkeypatch.setattr(api, "_main_tensor_parallel",
                        lambda p, world, backend: started.append(
                            (p["model"], world, backend)) or 0)
    (tmp_path / "params.json").write_text(json.dumps(params))
    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path))
    assert api.main() == 0
    assert started == [("mixtral-8x7b", 4, "nccl")]


@pytest.mark.parametrize("params,exc,words", [
    ({"mesh_sequence": 2}, NotImplementedError, "mesh_sequence=2"),
    ({"mesh_expert": 2, "adapter_pool": 2}, NotImplementedError,
     r"\['adapter_pool'\] under mesh_expert=2"),
    ({"mesh_expert": 2, "mesh_tensor": 2, "quantize": "int8"},
     NotImplementedError, "quantize=.*under mesh_expert=2, mesh_tensor=2"),
    ({"mesh_expert": 2, "kv_host_pages": 8, "kv_paging": "paged"},
     NotImplementedError, "kv_host_pages"),
    ({"mesh_expert": 2, "preemption": "swap"}, NotImplementedError,
     "preemption"),
    ({"mesh_stage": 2}, ValueError, "pipeline \\(stage\\)"),
    ({"mesh_tensro": 2}, ValueError, "unknown mesh axis"),
    ({"mesh_tensor": 2, "kv_host_pages": 8, "kv_paging": "paged"},
     NotImplementedError, "kv_host_pages"),
    ({"mesh_tensor": 2, "adapter_pool": 2}, NotImplementedError,
     "adapter_pool"),
    ({"mesh_tensor": 2, "preemption": "swap"}, NotImplementedError,
     "preemption"),
    ({"mesh_tensor": 2, "quantize_kv": True}, NotImplementedError,
     "quantize_kv"),
    ({"mesh_tensor": 2, "collective_matmul": "on"}, NotImplementedError,
     "collective_matmul"),
    ({"mesh_tensor": 2, "collective_matmul": "ring"}, NotImplementedError,
     "collective_matmul"),
])
def test_main_refuses_what_the_tp_server_does_not_take(
        tmp_path, monkeypatch, params, exc, words):
    with pytest.raises(exc, match=words):
        _main_with(tmp_path, monkeypatch, params, backend="gloo")


def test_main_refuses_a_multi_host_serving_mesh(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "job-0.svc:8476")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    with pytest.raises(NotImplementedError, match="over 2 hosts"):
        _main_with(tmp_path, monkeypatch, {"mesh_tensor": 2},
                   backend="gloo")


@pytest.mark.parametrize("example", ["llama2-70b", "falcon-40b"])
def test_main_takes_the_examples_collective_matmul_auto(
        tmp_path, monkeypatch, capsys, example):
    """The two example servers that set ``collective_matmul: auto`` under
    ``mesh_tensor: 4`` pass main's parse (no refusal; the replica itself,
    which needs four GPUs, is stubbed) and main logs what "auto"
    resolves to."""
    import yaml

    spec = yaml.safe_load((ROOT / "examples" / example / "server.yaml")
                          .read_text())
    params = spec["spec"]["params"]
    assert params["mesh_tensor"] == 4 and params["collective_matmul"] \
        == "auto"
    started = []
    monkeypatch.setattr(api, "_main_tensor_parallel",
                        lambda p, world, backend: started.append(
                            (p["model"], world, backend)) or 0)
    (tmp_path / "params.json").write_text(json.dumps(params))
    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path))
    assert api.main() == 0
    assert started == [(example, 4, "nccl")]
    assert ("serve: collective_matmul='auto' under mesh_tensor=4 resolves "
            "to 'all_reduce'") in capsys.readouterr().out
