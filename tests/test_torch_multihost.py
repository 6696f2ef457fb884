"""PyTorch port: which devices a process of a group owns
(``parallel/distributed.py``), on the CPU.

* ``make_multihost_mesh()`` under ``torchrun``'s ``LOCAL_RANK`` /
  ``LOCAL_WORLD_SIZE`` at 1, 2, 4 and 8 visible cards: each process its own
  contiguous block, the blocks disjoint and covering the cards
  (``torch.device("cuda", i)`` needs no card);
* an uneven split and an empty block raise ``ValueError``;
* a card is known by its id: where each process of a host sees only its
  own card (``CUDA_VISIBLE_DEVICES`` set a rank), each takes it whatever
  ``LOCAL_WORLD_SIZE`` says, and two processes at cuda:0 of distinct cards
  do not clash; one card seen by both is refused;
* the group's check, in a two-process group under a real ``torchrun``
  (its agent serves the rendezvous store): joining under NCCL refused
  before NCCL is called, for a split of one card and for two ranks that
  claim the same cards; JAX's unequal-count error (its text, from its
  ``make_multihost_mesh`` on the same layout); the duplicate-card error
  under NCCL and not under gloo (the smoke's gloo ranks share cuda:0);
  through a ``TCPStore``, the same answer in each process, exchange after
  exchange.
* the rank the card tests and the smoke start, two of them under
  ``torchrun`` over gloo: a multihost Trainer's steps against one device.
"""

import json
import os
import socket
import sys
import threading
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from lrp_imagecaptioning_tpu import parallel as jpar  # noqa: E402
from lrp_imagecaptioning_torch.parallel import distributed as tdist  # noqa: E402
from lrp_imagecaptioning_torch.parallel import make_multihost_mesh  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def _cards(n):
    return [torch.device("cuda", i) for i in range(n)]


@pytest.fixture
def visible(monkeypatch):
    """``visible(n)``: n cards visible to the default mesh."""
    def visible(n):
        monkeypatch.setattr(tdist, "cuda_devices", lambda: _cards(n))
        monkeypatch.setattr(tdist, "_card_id", lambda i: f"GPU-{i}")

    return visible


@pytest.mark.parametrize("n, local_world", [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4),
                                            (8, 1), (8, 2), (8, 4), (8, 8)])
def test_each_process_takes_its_block_of_cards(monkeypatch, visible, n, local_world):
    visible(n)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    blocks = []
    for local_rank in range(local_world):
        monkeypatch.setenv("LOCAL_RANK", str(local_rank))
        mesh = make_multihost_mesh()
        assert mesh.devices.shape == (n // local_world, 1)
        blocks.append(mesh.slots)
        assert tdist.local_devices() == mesh.slots
    assert [d for b in blocks for d in b] == _cards(n)
    per = n // local_world
    assert blocks == [_cards(n)[r * per:(r + 1) * per] for r in range(local_world)]


def test_without_local_rank_a_process_takes_every_card(monkeypatch, visible):
    visible(4)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert make_multihost_mesh(model_parallel=2).devices.tolist() == [_cards(4)[:2],
                                                                      _cards(4)[2:]]


@pytest.mark.parametrize("n, local_world", [(1, 2), (3, 2), (4, 3), (8, 3), (2, 4)])
def test_uneven_split_raises(monkeypatch, visible, n, local_world):
    visible(n)
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    with pytest.raises(ValueError, match=f"{n} visible cards do not split into "
                                         f"LOCAL_WORLD_SIZE={local_world} equal blocks"):
        make_multihost_mesh()


@pytest.mark.parametrize("n, local_rank, local_world", [(4, 2, 2), (4, -1, 2), (0, 0, 1),
                                                        (0, 0, 2)])
def test_empty_block_raises(monkeypatch, visible, n, local_rank, local_world):
    visible(n)
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    with pytest.raises(ValueError, match=f"LOCAL_RANK={local_rank} takes no card"):
        make_multihost_mesh()


def test_local_rank_without_local_world_size_raises(monkeypatch, visible):
    visible(2)
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="LOCAL_RANK and LOCAL_WORLD_SIZE go together"):
        make_multihost_mesh()


def _port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_unequal_error(monkeypatch):
    """The JAX package's ``make_multihost_mesh`` on two processes, process 0
    owning two devices and process 1 one."""
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    devices = [SimpleNamespace(process_index=p, id=i) for i, p in enumerate((0, 0, 1))]
    with pytest.raises(ValueError) as err:
        jpar.make_multihost_mesh(devices=devices)
    return str(err.value)


def test_group_refuses_unequal_and_shared_devices_over_gloo(tmp_path, monkeypatch):
    """Two ranks of one ``torchrun`` (LOCAL_WORLD_SIZE=2) on the CPU, the
    cards they see stood in for: both refused joining under NCCL (one card
    split in two; two ranks claiming the same cards), each rank given its
    own card on a masked layout, then, in the gloo group, JAX's
    unequal-count error, a shared card refused under NCCL only and distinct
    cards at one index accepted; each time the same answer in both."""
    sys.path.insert(0, HERE)
    import torch_parallel_worker as worker

    prefix = str(tmp_path / "claims")
    (log, rc), = worker.finish(worker.launch(2, ["--claims", prefix], cwd=tmp_path), timeout=120)
    assert rc == 0, log
    got = []
    for r in range(2):
        with open(f"{prefix}{r}.json") as f:
            got.append(json.load(f))
    want = _jax_unequal_error(monkeypatch)
    assert want == "process 0 owns 2 devices, expected 1"
    host = socket.gethostname()
    for r, (split, clash, mine, unequal, shared_gloo, shared_nccl, masked) in enumerate(got):
        assert split == "1 visible cards do not split into LOCAL_WORLD_SIZE=2 equal blocks"
        assert clash.startswith(f"processes 0 and 1 both hold card GPU-0 on host {host} "
                                f"(cuda:0 in process 0, cuda:0 in process 1): ")
        assert mine == ["cuda:0"]
        assert unequal == want
        assert shared_gloo is None
        assert shared_nccl.startswith(f"processes 0 and 1 both hold card GPU-1 on host {host} "
                                      f"(cuda:1 in process 0, cuda:0 in process 1): ")
        assert masked is None


VIEWS = {   # each process's [LOCAL_RANK, LOCAL_WORLD_SIZE, the ids it sees]
    "masked, one card a rank": [["0", "2", ["A"]], ["1", "2", ["B"]]],
    "masked, four ranks": [[str(r), "4", [f"G{r}"]] for r in range(4)],
    "masked, two cards a rank": [["0", "2", ["A", "B"]], ["1", "2", ["C", "D"]]],
    "shared, split": [["0", "2", ["A", "B"]], ["1", "2", ["A", "B"]]],
    "overlapping, split": [["0", "2", ["A", "B"]], ["1", "2", ["B", "C"]]],
    "no LOCAL_*": [[None, None, ["A"]], [None, None, ["B"]]],
}


@pytest.mark.parametrize("layout, owned", [
    ("masked, one card a rank", [["A"], ["B"]]),
    ("masked, four ranks", [["G0"], ["G1"], ["G2"], ["G3"]]),
    ("masked, two cards a rank", [["A", "B"], ["C", "D"]]),
    ("shared, split", [["A"], ["B"]]),
    ("overlapping, split", [["A"], ["C"]]),
    ("no LOCAL_*", [["A"], ["B"]]),
])
def test_each_process_takes_its_own_cards_by_id(layout, owned):
    """Where each process of a host sees only its own cards, it takes them
    all; where they see the same cards, the split; the blocks, known by the
    cards' ids, pass the NCCL group's check."""
    views = [["h", *v] for v in VIEWS[layout]]
    blocks = [tdist._block(v, views) for v in views]
    assert [[v[3][i] for i in b] for v, b in zip(views, blocks)] == owned
    tdist._check_ownership([["h", len(b), {v[3][i]: i for i in b}]
                            for v, b in zip(views, blocks)])


def test_one_card_seen_by_two_processes_is_refused():
    """Both processes of a host see one card and LOCAL_WORLD_SIZE=2: the
    split refuses it; with LOCAL_WORLD_SIZE=1 each takes it and the NCCL
    group's check refuses the clash, naming both indices; on two hosts the
    same index of distinct cards is no clash."""
    views = [["h", "0", "2", ["A"]], ["h", "1", "2", ["A"]]]
    with pytest.raises(ValueError, match="1 visible cards do not split into LOCAL_WORLD_SIZE=2"):
        tdist._block(views[0], views)
    claims = [["h", 1, {"A": 0}], ["h", 1, {"A": 0}]]
    with pytest.raises(ValueError, match=r"processes 0 and 1 both hold card A on host h "
                                         r"\(cuda:0 in process 0, cuda:0 in process 1\)"):
        tdist._check_ownership(claims)
    tdist._check_ownership(claims, exclusive=False)
    tdist._check_ownership([["h", 1, {"A": 0}], ["h", 1, {"B": 0}]])
    tdist._check_ownership([["h0", 1, {"A": 0}], ["h1", 1, {"B": 0}]])


@pytest.mark.parametrize("claims, error", [
    ([[0, 1], [2, 3]], None),
    ([[0, 1], [1, 2]], "processes 0 and 1 both hold card GPU-1 on host "),
    ([[0], [0, 1]], "process 1 owns 2 devices, expected 1"),
])
def test_store_check_before_the_group_connects(monkeypatch, claims, error):
    """``initialize_distributed``'s check under NCCL, before the
    communicator connects: the claims gathered through a ``TCPStore`` (two
    threads stand for two processes), the same answer in each, on the
    first exchange and on the second."""
    monkeypatch.setattr(tdist, "_card_id", lambda i: f"GPU-{i}")
    port = _port()
    results = [[], []]

    def run(rank):
        store = torch.distributed.TCPStore("localhost", port, 2, rank == 0)
        cards = [torch.device("cuda", i) for i in claims[rank]]
        for _ in range(2):
            gathered = tdist._store_all_gather(store, rank, 2, tdist._claim(cards))
            try:
                tdist._check_ownership(gathered)
                results[rank].append("ok")
            except ValueError as e:
                results[rank].append(str(e))

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for got in results:
        assert len(got) == 2
        for one in got:
            assert one == "ok" if error is None else one.startswith(error), results


def test_torchrun_ranks_over_gloo_match_one_device(tmp_path):
    """The rank the card tests and the smoke start (``torch_parallel_worker
    --rank``), here two ranks of one ``torchrun`` over gloo on the CPU: a
    multihost Trainer's two train steps and a sharded fine-tune step on each
    rank's rows, rank 0 against the one-device step (loss rel 1e-5, every
    gradient leaf within 1e-4 of its scale, Adam's flips none), the ranks'
    params bit for bit equal after each step."""
    sys.path.insert(0, HERE)
    import torch_parallel_worker as worker

    prefix = str(tmp_path / "rank")
    (log, rc), = worker.finish(worker.launch(
        2, ["--rank", prefix, "--backend", "gloo", "--steps", "train,train,finetune"],
        cwd=tmp_path), timeout=240)
    assert rc == 0, log
    got = [worker.load_rank(f"{prefix}{r}.npz") for r in range(2)]
    assert [z["mesh"] for z in got] == [[["cpu"]]] * 2
    for k in range(3):
        assert got[0][f"{k}_loss_rel"] <= 1e-5 and got[0][f"{k}_leaf_dist"] <= 1e-4, got[0]
        assert got[0][f"{k}_apart"] == 0.0
        assert got[0][f"{k}_digest"] == got[1][f"{k}_digest"]
        assert got[0][f"{k}_loss"] == got[1][f"{k}_loss"]
