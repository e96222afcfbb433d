"""The seeded fixtures: their existing outputs stay byte-identical as the
module grows (the wide-feature option and the grammar were added beside
them), and the new parts are what they say."""

import hashlib
import os

import numpy as np
import pytest

from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.models.jsgf import JsgfGrammar

# sha256 (first 16 hex digits) of each fixture's cepstra and of the files
# write_model_dir wrote for it before the grammar files were added.
PINNED = {("cont", "SMALL"): "07c652f1bf7dd0ed",
          ("semi", "SMALL"): "28a6fa2720cf9f5b",
          ("s2_4x", "SMALL"): "db829cd44afdcfb1",
          ("ptm", "SMALL"): "62c8e4b49d98208e",
          ("cont", "MEDIUM"): "f3800340a0c64428"}


@pytest.mark.parametrize("model,size", sorted(PINNED))
def test_seed0_outputs_are_byte_identical(model, size, tmp_path):
    fx = fixture.build(0, model=model, size=getattr(fixture, size))
    h = hashlib.sha256()
    for c in fx.ceps:
        h.update(c.tobytes())
    kw = fixture.write_model_dir(fx, str(tmp_path))
    for f in sorted(os.listdir(kw["hmm"])):
        h.update(f.encode())
        h.update(open(os.path.join(kw["hmm"], f), "rb").read())
    for f in ("lm.arpa", "words.dict"):
        h.update(open(os.path.join(str(tmp_path), f), "rb").read())
    assert h.hexdigest()[:16] == PINNED[(model, size)]
    assert {"grammar.jsgf", "grammar.fsg"} <= set(os.listdir(tmp_path))


def test_wide_feature_fixture():
    fx = fixture.build(0, size=fixture.SMALL, ncep=26)
    assert fx.gauden.veclen == [78] and fx.feat_params["ceplen"] == 26
    assert all(c.shape[1] == 26 for c in fx.ceps)
    assert len(fx.ceps) == fixture.SMALL.n_utt
    with pytest.raises(ValueError, match="continuous"):
        fixture.build(0, model="semi", size=fixture.SMALL, ncep=26)


@pytest.mark.parametrize("size", ["SMALL", "MEDIUM"])
def test_grammar_accepts_transcripts_and_word_loops(size):
    fx = fixture.build(0, size=getattr(fixture, size))
    sents, vocab = fixture.grammar_parts(fx)
    rng = np.random.RandomState(1)
    loops = [list(rng.choice(vocab, rng.randint(1, 5))) for _ in range(5)]
    fsg = fixture.grammar_fsg(fx)
    assert fsg.n_state == 4 + sum(len(s) - 1 for s in sents)
    assert len(fsg.word_links()) == len(vocab) + sum(map(len, sents))
    grammars = [fsg]
    if size == "SMALL":       # the JSGF compiler's FSG: 3 states a word
        grammars.append(JsgfGrammar.parse(fixture.grammar_jsgf(fx)).build_fsg())
    for g in grammars:
        for words in fx.transcripts + loops:
            assert g.accept(words), words
        assert not g.accept([])
        assert not g.accept(["<nope>"])
