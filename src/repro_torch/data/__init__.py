"""Datasets, non-IID allocation and minibatching (numpy copies of the JAX
package's data builders, plus the node-batched torch Batcher)."""
from repro_torch.data.allocation import (  # noqa: F401
    gini_index,
    split_by_allocation,
    zipf_allocation,
)
from repro_torch.data.pipeline import Batcher, minibatches  # noqa: F401
from repro_torch.data.synth import (  # noqa: F401
    DATASETS,
    SynthDataset,
    make_dataset,
)
from repro_torch.data.tokens import (  # noqa: F401
    lm_input_specs,
    synthetic_token_batch,
)
