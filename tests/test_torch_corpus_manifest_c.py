"""Part 3 of 3 of the frozen corpus's clips: the JAX package's container
hash for each (clip, mode), on the CPU, against the manifest (see
test_torch_corpus_manifest.py, which holds parts 1 and the writer)."""
import pytest
from test_torch_corpus_manifest import check_entry, clip_entry, man, part_clips  # noqa: F401


@pytest.mark.parametrize("name", part_clips(2))
def test_jax_containers_match_the_manifest(man, name):  # noqa: F811 (man: the fixture)
    check_entry(name, clip_entry(name), man)
