"""Training data: the synthetic corpora, the wav-directory corpus, crops,
the Python iterator and the prefetch thread (`pipeline.py`); the C++
loader (`native_loader.py`); the grain engine (`grain_pipeline.py`)."""

from pwn_tpu_torch.data.pipeline import (  # noqa: F401
    SyntheticSpeech,
    SyntheticTones,
    WavCropDataset,
    corpus_split,
    make_train_iterator,
    prefetch,
)
