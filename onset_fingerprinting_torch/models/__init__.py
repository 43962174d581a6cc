"""Fingerprint models, the trainer, the flax-params importer
(``jax_import``) and the reference-checkpoint maps (``torch_import``)."""

from onset_fingerprinting_torch.models.fcnn import FCNN, FCNNBundle
from onset_fingerprinting_torch.models.cnn import CNN
from onset_fingerprinting_torch.models.rnn import RNN, CNNRNN
from onset_fingerprinting_torch.models.cccnn import CCCNN, paired_xcorr
from onset_fingerprinting_torch.models.train import (
    TrainState,
    Trainer,
    make_optimizer,
)
from onset_fingerprinting_torch.models.torch_import import (
    fcnn_state_dict_from_reference,
    load_reference_setup,
)
