"""The frozen task generator against the program's (`fixture.py`) and
through the program's entry; the traffic's plan of batches."""

import filecmp

import pytest

from portbench import kinds
from portbench.gen import task as gen_task

FILES = ["hmm/mdef", "hmm/means", "hmm/variances", "hmm/transition_matrices",
         "hmm/feat.params", "hmm/noisedict", "lm.arpa", "words.dict"]


def small(model):
    """The program's SMALL size: the shared keys and the kind's own."""
    from cmusphinx_tpu_torch import fixture
    return gen_task.Size.from_dict({k: getattr(fixture.SMALL, k) for k in (
        "n_phone", "n_sen", "n_word", "pron_len", "n_sent", "sent_len",
        *kinds.load(model).SIZE_KEYS)})


@pytest.mark.parametrize("model,weights", [("cont", "hmm/mixture_weights"),
                                           ("semi", "hmm/sendump")])
@pytest.mark.parametrize("seed", [0, 5])
def test_model_files_equal_the_programs(tmp_path, model, weights, seed):
    from cmusphinx_tpu_torch import fixture
    fx = fixture.build(seed, model=model, size=fixture.SMALL)
    fixture.write_model_dir(fx, str(tmp_path / "program"))
    task = gen_task.build(seed, model, small(model), [120, 160])
    gen_task.write_model_dir(task, str(tmp_path / "frozen"))
    for f in FILES + [weights]:
        assert filecmp.cmp(tmp_path / "program" / f, tmp_path / "frozen" / f,
                           shallow=False), f


@pytest.mark.parametrize("model", ["cont", "semi"])
def test_decoder_decodes_the_pool(tmp_path, model):
    from cmusphinx_tpu_torch.api import Decoder
    lengths = [100, 140, 170, 200]
    task = gen_task.build(0, model, small(model), lengths)
    assert [len(c) for c in task.ceps] == lengths
    kw = gen_task.write_model_dir(task, str(tmp_path))
    dec = Decoder(device="cpu", **kw)
    hyps = dec.search.decode_batch_cep(task.ceps, dec.fp)
    assert [h.words for h in hyps] == task.transcripts


def test_the_seed_changes_weights_and_speech_not_sizes_or_structure():
    a = gen_task.build(1, "cont", small("cont"), [90, 120], structure_seed=9)
    b = gen_task.build(2, "cont", small("cont"), [90, 120], structure_seed=9)
    assert [len(c) for c in a.ceps] == [len(c) for c in b.ceps] == [90, 120]
    assert not (a.ceps[0] == b.ceps[0]).all()
    assert not (a.am.means == b.am.means).all()
    assert a.mdef_lines == b.mdef_lines and a.prons == b.prons
    assert (a.lm.tg_prob == b.lm.tg_prob).all()


@pytest.mark.parametrize("seed", [1, 2001, 2**31 + 7])
def test_checked_batches_are_ones_every_run_decodes(seed):
    """The checked batches lie among those every run decodes, the first
    holding the pool's longest utterance; a pass covers the pool."""
    from portbench import traffic
    mix = {"kind": "batch", "pool": 128, "frames": [200, 600], "batch": 16,
           "profile_batches": 1, "check_batches": 2}
    plan = traffic.batch_plan(mix, seed, 40)
    checked = traffic.check_batches(mix, seed, plan)
    assert checked[0] == 0 and 127 in plan[0]
    assert len(checked) == 2 and max(checked) < traffic.decoded(mix) == 3
    assert sorted(sum(plan[:8], [])) == list(range(128))
    assert plan == traffic.batch_plan(mix, seed, 40)
