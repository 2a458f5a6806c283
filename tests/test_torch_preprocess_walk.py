"""The port's host-side extraction walkers and views ≡ the JAX package's:
the raw IEMOCAP walk, the transcript ↔ avi alignment, the per-utterance
extraction loop (its failure → [] included), MOSEI's adaptation and its
entry point, the openSMILE steps and entry point, and every raw-corpus and
extraction-view registry name.  All host code: compared exactly (floats
from the same numpy operations bit for bit).  The trees, dumps, csd and
csv files are fabricated under pytest's tmp_path.
"""

import os
import pickle
import stat

import numpy as np
import pytest

from erc_tpu.data import iemocap_raw as jraw
from erc_tpu.data import registry as jregistry
from erc_tpu.preprocess import mosei as jmosei
from erc_tpu.preprocess import opensmile as josm
from erc_tpu.preprocess import video_walk as jwalk
from erc_tpu_torch.data import iemocap_raw as traw
from erc_tpu_torch.data import registry as tregistry
from erc_tpu_torch.preprocess import mosei as tmosei
from erc_tpu_torch.preprocess import opensmile as tosm
from erc_tpu_torch.preprocess import video_walk as twalk
from torch_threads import _one_torch_thread  # noqa: F401 (autouse fixture)

RAW_NAMES = ["iemocap-audio-raw-9", "iemocap-audio-4", "iemocap-audio-v1-4", "iemocap-audio-6", "iemocap-text-4",
             "iemocap-text-v1-4", "iemocap-text-6", "iemocap-ta-4", "iemocap-ta-v1-4", "iemocap-ta-6"]
VIEW_NAMES = ["iemocap-cogmen-text-4", "iemocap-cogmen-text-6", "meld-mmgcn-text-7", "iemocap-cogmen-video-4",
              "iemocap-cogmen-video-6", "mosei-text-any-7", "mosei-interval-any-7"]


def _same(got, want, path="") -> None:
    """Recursive equality of nested dicts, lists, tuples and arrays (NaN equal to NaN)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and (got == want or (got != got and want != want)), (path, got, want)


# ------------------------------------------------------------- the raw corpus
UTTS = {  # session → dialogue → [(utterance id, sentence, t0, t1, votes)]
    "Session1": {"Ses01F_impro01": [
        ("Ses01F_impro01_F000", "Excuse me.", 6.29, 8.23, ["Neutral", "Neutral", "Happiness"]),
        ("Ses01F_impro01_M001", "Yeah.", 9.1, 10.5, ["Anger", "Frustration", "Anger"]),
        ("Ses01F_impro01_F002", "Is there a problem?", 10.6, 12.0, ["Sadness", "Excited", "Excited"])]},
    "Session2": {"Ses02M_script01_1": [
        ("Ses02M_script01_1_M000", "No.", 0.5, 1.1, ["Frustration", "Frustration"]),
        ("Ses02M_script01_1_F001", "I see.", 1.3, 2.4, ["Happiness", "Neutral", "Happiness"])]},
    "Session5": {"Ses05M_script01_1": [
        ("Ses05M_script01_1_M000", "I got it.", 1.0, 2.5, ["Excited", "Excited"]),
        ("Ses05M_script01_1_F001", "Did you?", 3.0, 4.2, ["Surprise", "Happiness", "Happiness"]),
        ("Ses05M_script01_1_M002", "Sure.", 4.4, 5.0, ["Other", "Other"])]},
}


def _mk_raw_tree(root):
    """The release tree's label, transcript and wav files; one utterance has
    no wav, one no transcript line."""
    for sess, dias in UTTS.items():
        for dia, utts in dias.items():
            cat = os.path.join(root, sess, "dialog/EmoEvaluation/Categorical")
            tra = os.path.join(root, sess, "dialog/transcriptions")
            wav = os.path.join(root, sess, "sentences/wav", dia)
            for p in (cat, tra, wav):
                os.makedirs(p, exist_ok=True)
            with open(os.path.join(cat, dia + "_cat.txt"), "w") as f:
                for uid, _, _, _, votes in utts:
                    f.writelines(f"{uid} :{v}; ()\n" for v in votes)
            with open(os.path.join(tra, dia + ".txt"), "w") as f:
                for uid, sent, t0, t1, _ in utts:
                    if not uid.endswith("F002"):
                        f.write(f"{uid} [{t0:.4f}-{t1:.4f}]: {sent}\n")
            for uid, *_ in utts:
                if not uid.endswith("M001"):
                    open(os.path.join(wav, uid + ".wav"), "wb").close()


def test_iemocap_raw_walk_equals_jax(tmp_path):
    root = str(tmp_path)
    _mk_raw_tree(root)
    assert traw._TRANS_RE.pattern == jraw._TRANS_RE.pattern and traw.CLASS_MAPS == jraw.CLASS_MAPS
    for split in ("train", "test"):
        _same(traw.walk_utterances(root, split), jraw.walk_utterances(root, split))
        for view in ("iemocap_text", "iemocap_audio", "iemocap_text_audio"):
            _same(getattr(traw, view)(root, split), getattr(jraw, view)(root, split))
        for n in ("4", "4.1", "6"):
            for sub in ("iemocap_text_subset", "iemocap_audio_subset", "iemocap_text_audio_subset"):
                _same(getattr(traw, sub)(n)(root, split), getattr(jraw, sub)(n)(root, split))
    assert [r["label"] for r in traw.walk_utterances(root, "test")] == ["Happiness", "Excited", "Other"]
    lines = ["Ses01F_x_F000 :Neutral; Anger; ()", "noise", "Ses01F_x_F000 :Anger; ()"]
    assert traw.parse_label_votes(lines) == jraw.parse_label_votes(lines) == {"Ses01F_x_F000": "Anger"}


# -------------------------------------------------------- video walk + alignment
ROWS = [("F000", 0.5, 1.0, "Excuse me."), ("M001", 1.2, 2.0, "Dropped by the dump."),
        ("F002", 2.1, 3.0, "Yeah."), ("M003", 3.1, 3.6, "Fine.")]


def _mk_release_tree(root, dias=("Ses01F_impro01", "Ses01M_script02_1"), avis=True):
    tra = os.path.join(root, "Session1/dialog/transcriptions")
    avi = os.path.join(root, "Session1/dialog/avi/DivX")
    os.makedirs(tra, exist_ok=True), os.makedirs(avi, exist_ok=True)
    for dia in dias:
        with open(os.path.join(tra, dia + ".txt"), "w") as f:
            f.write("garbage line\n")
            f.writelines(f"{dia}_{u} [{t0:.4f}-{t1:.4f}]: {s}\n" for u, t0, t1, s in ROWS)
        if avis:
            open(os.path.join(avi, dia + ".avi"), "wb").close()


def test_video_alignment_equals_jax(tmp_path):
    root = str(tmp_path)
    _mk_release_tree(root)
    sentences = {"Ses01F_impro01": ["Excuse me.", "Yeah.", "Fine."], "Ses01M_script02_1": ["Yeah."],
                 "Ses01F_missing": ["Hello."], "Ses01F_impro01_bad": ["x"]}
    speakers = {k: [[1, 0]] * len(v) for k, v in sentences.items()}
    labels = {k: [2] * len(v) for k, v in sentences.items()}
    _same(twalk.parse_transcripts(root), jwalk.parse_transcripts(root))
    _same(twalk.find_avis(root), jwalk.find_avis(root))
    _same(twalk.align_transcripts(twalk.parse_transcripts(root), sentences),
          jwalk.align_transcripts(jwalk.parse_transcripts(root), sentences))
    got = twalk.video_alignment(root, sentences, speakers, labels)
    _same(got, jwalk.video_alignment(root, sentences, speakers, labels))
    assert sorted(got) == ["Ses01F_impro01", "Ses01M_script02_1"]
    assert [s[0] for s in got["Ses01F_impro01"]["timestamp"]] == ["Ses01F_impro01_F000", "Ses01F_impro01_F002",
                                                                  "Ses01F_impro01_M003"]


def test_extract_dialogue_features_equals_jax_and_fails_to_empty(tmp_path):
    T, H, W, fps = 40, 480, 720, 10.0
    frames = np.random.default_rng(2).integers(0, 255, (T, H, W, 3)).astype(np.uint8)

    def read_video(fn):
        if "Ses01F" not in fn:
            raise IOError(f"cannot decode {fn}")
        return frames, fps

    def extract(arr):  # a deterministic stand-in for the backbone
        return np.concatenate([arr.mean(axis=(0, 1, 2)), [arr.shape[0], arr.shape[2]]]).astype(np.float32)

    clips = {
        "Ses01F_d": {"fn": "/x/Ses01F_d.avi", "timestamp": [["u0", 0.5, 1.0], ["u1", 2.0, 3.0], ["u2", 3.1, 3.7]],
                     "speaker": [[1, 0], [0, 1], 1]},
        "Ses01M_d": {"fn": "/x/Ses01M_d.avi", "timestamp": [["u0", 0.5, 1.0]], "speaker": [[1, 0]]},
        "Ses01F_broken": {"fn": "/x/Ses01F_broken.avi", "timestamp": [["u0", 0.5, 1.0]], "speaker": [[1, 0]]},
    }

    def broken_extract(arr):
        if arr.shape[0] == 5 and len(seen) >= 3:
            raise RuntimeError("device fault")
        seen.append(arr.shape)
        return extract(arr)

    logs = {"port": [], "jax": []}
    seen = []
    got = twalk.extract_dialogue_features(clips, broken_extract, read_video, log=logs["port"].append)
    seen.clear()
    want = jwalk.extract_dialogue_features(clips, broken_extract, read_video, log=logs["jax"].append)
    _same(got, want)
    assert got["Ses01F_d"].shape == (3, 5) and got["Ses01M_d"] == [] and got["Ses01F_broken"] == []
    assert len(logs["port"]) == len(logs["jax"]) == 2
    clip = np.random.default_rng(3).integers(0, 255, (3, 400, 600, 3)).astype(np.uint8)
    for left in (True, False):
        _same(twalk.crop_speaker(clip, left), jwalk.crop_speaker(clip, left))


def test_dialogue_walk_through_the_port_extractor_equals_per_utterance_calls(tmp_path):
    """The walk with the port's TSN extractor (ResNet-50 on the CPU, crop
    32, 2 segments): each dialogue's rows equal one ``extract`` call a clip."""
    from erc_tpu_torch.preprocess.video import TSNExtractor

    ex = TSNExtractor(n_segments=2, crop_size=32, device="cpu", seed=3)
    frames = np.random.default_rng(4).integers(0, 255, (30, 480, 720, 3)).astype(np.uint8)
    clips = {"Ses01F_a": {"fn": "Ses01F_a.avi", "timestamp": [["u0", 0.2, 1.0], ["u1", 1.1, 2.0]],
                          "speaker": [[1, 0], [0, 1]]}}
    out = twalk.extract_dialogue_features(clips, ex.extract, lambda fn: (frames, 15.0))
    assert out["Ses01F_a"].shape == (2, 2048) and np.isfinite(out["Ses01F_a"]).all()
    np.testing.assert_array_equal(out["Ses01F_a"][1], ex.extract(twalk.crop_speaker(frames[16:30], False)))


# ------------------------------------------------------------------- MOSEI
def _mosei_inputs(root):
    """mosei_senti_data.pkl, CMU_MOSEI_Labels.csd (h5) and the segmented
    transcripts of three videos; one utterance's text window is all zero
    (pooled to NaN), one audio window empty, one shorter than 0.5 s."""
    import h5py

    rng = np.random.default_rng(0)
    ids = {"train": [["vidA", "0.0", "2.0"], ["vidA", "2.0", "4.5"], ["vidD", "1.0", "1.3"]],
           "test": [["vidB", "0.0", "0.3"]], "valid": [["vidC", "1.0", "3.0"]]}

    def win(d, empty=False):
        w = np.zeros((6, d), np.float32)
        if not empty:
            w[[1, 4]] = rng.normal(size=(2, d))
        return w

    align = {split: {"id": np.array(sid, dtype=object),
                     "vision": np.stack([win(3) for _ in sid]),
                     "audio": np.stack([win(4, empty=split == "test") for _ in sid]),
                     "text": np.stack([win(5, empty=(split == "valid")) for _ in sid])}
             for split, sid in ids.items()}
    with open(os.path.join(root, "mosei_senti_data.pkl"), "wb") as f:
        pickle.dump(align, f)
    os.makedirs(os.path.join(root, "Combined"))
    with h5py.File(os.path.join(root, "CMU_MOSEI_Labels.csd"), "w") as f:
        data = f.create_group("All Labels").create_group("data")
        for key in ("vidA", "vidB", "vidC", "vidD"):
            rows = [r for s in ids.values() for r in s if r[0] == key]
            g = data.create_group(key)
            g["intervals"] = np.array([[float(r[1]), float(r[2])] for r in rows])
            g["features"] = rng.normal(size=(len(rows), 7)).astype(np.float32)
            with open(os.path.join(root, "Combined", f"{key}.txt"), "w") as t:
                t.writelines(f"{key}___{i}___{r[1]}___{r[2]}___utterance {i} of {key}\n\n"
                             for i, r in enumerate(rows))
    return align


def test_adapt_mosei_and_its_entry_equal_jax(tmp_path):
    root = str(tmp_path)
    align = _mosei_inputs(root)
    labels = tmosei.load_mosei_labels(os.path.join(root, "CMU_MOSEI_Labels.csd"))
    _same(labels, jmosei.load_mosei_labels(os.path.join(root, "CMU_MOSEI_Labels.csd")))
    trans = tmosei.load_transcripts(os.path.join(root, "Combined"))
    _same(trans, jmosei.load_transcripts(os.path.join(root, "Combined")))
    for t in (None, trans):
        _same(tmosei.adapt_mosei(align, labels, t), jmosei.adapt_mosei(align, labels, t))
    outs = {}
    for name, mod in (("port", tmosei), ("jax", jmosei)):
        outs[name] = os.path.join(root, f"{name}.pkl")
        mod.main([f"--senti_pkl={root}/mosei_senti_data.pkl", f"--labels_csd={root}/CMU_MOSEI_Labels.csd",
                  f"--transcript_root={root}/Combined", f"--out={outs[name]}"])
    with open(outs["port"], "rb") as f, open(outs["jax"], "rb") as g:
        got, want = pickle.load(f), pickle.load(g)
    _same(got, want)
    assert got[0] == ["vidA", "vidD"] and np.isnan(got[6]["vidC"]).all() and got[12]


# ---------------------------------------------------------------- openSMILE
FAKE_SMILEXTRACT = """#!/bin/sh
# SMILExtract -C conf -I wav -csvoutput csv: one feature row from the wav's size
printf "name;frameTime;bytes\\n'unknown';0.0;%s\\n" "$(wc -c < "$4")" > "$6"
"""


def test_opensmile_steps_and_entry_equal_jax(tmp_path):
    rate = 100
    sig = np.arange(600, dtype=np.int16)
    wav_root = tmp_path / "wavs"
    wav_root.mkdir()
    tosm.write_wav(str(wav_root / "vidA.wav"), rate, sig)
    intervals = {"vidA": np.array([[0.0, 1.0], [-0.5, 3.0], [4.0, 5.5]], np.float32),
                 "missing": np.array([[0.0, 1.0]], np.float32)}
    segs = {}
    for name, mod in (("port", tosm), ("jax", josm)):
        segs[name] = mod.segment_wavs(intervals, str(wav_root), str(tmp_path / f"segs_{name}"))
    assert [os.path.basename(s) for s in segs["port"]] == [os.path.basename(s) for s in segs["jax"]]
    for a, b in zip(segs["port"], segs["jax"]):
        _same(tosm.read_wav(a), josm.read_wav(b))
    text = "name;f1;f2\n'unknown';1.5;-2.25\n"
    _same(tosm.parse_is10_csv(text), josm.parse_is10_csv(text))
    csv_dir = tmp_path / "csv"
    csv_dir.mkdir()
    for key, i, vals in (("vidA", 0, "1.5;2.5"), ("vidA", 10, "3.0;4.0"), ("vidA", 2, "5;6"),
                         ("vid_B", 0, "9.0;8.0")):
        (csv_dir / f"{key}_{i:02d}.wav.csv").write_text("name;f1;f2\n" + f"'unknown';{vals}\n")
    (csv_dir / "stray.txt").write_text("x")
    got = tosm.collect_features(str(csv_dir))
    _same(got, josm.collect_features(str(csv_dir)))
    assert got["vidA"][:, 1].tolist() == [1.5, 5.0, 3.0]  # numeric segment order

    smile = tmp_path / "SMILExtract"
    smile.write_text(FAKE_SMILEXTRACT)
    smile.chmod(smile.stat().st_mode | stat.S_IEXEC)
    with open(tmp_path / "adapted.pkl", "wb") as f:
        pickle.dump([[], [], [], intervals], f)
    outs = {}
    for name, mod in (("port", tosm), ("jax", josm)):
        outs[name] = str(tmp_path / f"{name}.is10.pkl")
        mod.main([f"--adapted_pkl={tmp_path}/adapted.pkl", f"--wav_root={wav_root}",
                  f"--seg_dir={tmp_path}/main_segs_{name}", f"--csv_dir={tmp_path}/main_csv_{name}",
                  f"--smilextract={smile}", f"--out={outs[name]}"])
    with open(outs["port"], "rb") as f, open(outs["jax"], "rb") as g:
        got, want = pickle.load(f), pickle.load(g)
    _same(got, want)
    assert got["vidA"].shape == (3, 3) and got["vidA"][0, 2] == 44 + 200


# ---------------------------------------------------------------- registry
def _mk_roots(base):
    """Every root the raw and view names read: the raw release tree and the
    COGMEN dumps with their own release tree under iemocap/, the MMGCN MELD
    dump under meld/, the adapted MOSEI pickle under mosei/."""
    iemocap = os.path.join(base, "iemocap")
    _mk_raw_tree(iemocap)
    _mk_release_tree(os.path.join(iemocap, "IEMOCAP_full_release"))
    rng = np.random.default_rng(9)
    for rel, n in (("cogmen/iemocap_4/IEMOCAP_features_4.pkl", 4), ("cogmen/iemocap/IEMOCAP_features.pkl", 6)):
        ids = ["Ses01F_impro01", "Ses01M_script02_1", "Ses05F_gone"]
        sent = {"Ses01F_impro01": ["Excuse me.", "Fine."], "Ses01M_script02_1": ["Yeah.", "Fine."],
                "Ses05F_gone": ["Hi."]}
        spk = {k: ["M" if i % 2 else "F" for i in range(len(v))] for k, v in sent.items()}
        lab = {k: rng.integers(0, n, len(v)).tolist() for k, v in sent.items()}
        feats = {k: rng.normal(size=(len(v), 4)).astype(np.float32) for k, v in sent.items()}
        os.makedirs(os.path.dirname(os.path.join(iemocap, rel)), exist_ok=True)
        with open(os.path.join(iemocap, rel), "wb") as f:
            pickle.dump(({k: k for k in ids}, spk, lab, feats, feats, feats, sent, ids[:2], ids[2:]), f)
    os.makedirs(os.path.join(base, "meld", "MMGCN"))
    with open(os.path.join(base, "meld", "MMGCN", "MELD_features_raw.pkl"), "wb") as f:
        pickle.dump(tuple([{}] * 6 + [{0: ["hi", "there"], 3: ["bye"]}] + [[0], [3], []]), f)
    os.makedirs(os.path.join(base, "mosei"))
    with open(os.path.join(base, "mosei", "MOSEI.adpated.pkl"), "wb") as f:
        pickle.dump([["a"], [], [], {"a": np.array([[0.0, 1.5]], np.float32)}, {}, {}, {}, {},
                     {"a": ["one sentence"]}, [], [], [], []], f)


@pytest.mark.parametrize("name", RAW_NAMES + VIEW_NAMES)
def test_registry_name_equals_jax(tmp_path, monkeypatch, name):
    _mk_roots(str(tmp_path))
    monkeypatch.setenv("ERC_TPU_DATA_ROOT", str(tmp_path))
    root = tregistry.get_root(name)
    assert root == jregistry.get_root(name)
    t = tregistry.regist_data.get(name) or tregistry.extraction_views[name]
    j = jregistry.regist_data[name]
    assert getattr(t, "keywords", {}) == getattr(j, "keywords", {})
    assert (name in tregistry.regist_data) == (name in RAW_NAMES)
    for split in ("train", "test"):
        got = tregistry.pick_datas(root, name, split)
        _same(got, jregistry.pick_datas(root, name, split))
        assert len(got) > 0
    if "video" in name:
        got = tregistry.pick_datas(root, name, release_dir="IEMOCAP_full_release")
        _same(got, jregistry.pick_datas(root, name, release_dir="IEMOCAP_full_release"))
        assert sorted(got) == ["Ses01F_impro01", "Ses01M_script02_1"]


def test_unknown_names_raise():
    with pytest.raises(ValueError, match="unknown dataset"):
        tregistry.pick_datas(None, "iemocap-nothing-4")
