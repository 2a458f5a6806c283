"""Shared ERC params: the dataset-name grammar → model dims derivation.

Port of ``erc_tpu.models.base.MMBaseParams``: the dataset string
``{dataset}-{feature_set}-[replacements]-{n_classes}`` drives hidden dims,
class names and speaker counts; ``synthetic-*`` names reuse the grammar
(synthetic-cogmen-6 has iemocap-cogmen geometry).  ``device`` selects where
the port runs (see ``core.device``).
"""

from __future__ import annotations

from erc_tpu_torch.core.params import BaseParams, Params


class MMBaseParams(BaseParams):
    def __init__(self):
        super().__init__()
        self.seed = 1
        self.module = None

        self.class_names = []
        self.modality = self.choice("atv", "av", "at", "tv", "t", "a", "v")
        self.n_speakers = 2
        self.speaker_onehot = False

        self.hidden_text = 100
        self.hidden_audio = 100
        self.hidden_visual = 100
        self.hidden_all = 300
        # the reference's published hyperparameters per dataset (models' iparams)
        self.reimplement = False

        self.epoch = 10
        self.train.batch_size = 32
        self.test.batch_size = 32
        # an int or "cuda[:N]" runs on the card, "cpu" on the CPU
        self.device = 0

        # the train step's forward and backward on bfloat16 copies of the
        # parameters and the batch; masters, gradients, optimizer state and
        # buffers stay float32, losses reduce in float32, eval is float32
        self.compute_dtype = self.choice("float32", "bfloat16")
        # float32 batch arrays rounded to bfloat16 on the host before the copy
        # to the card (half the bytes); the steps upcast them at entry
        self.transfer_dtype = self.choice("float32", "bfloat16")
        # float32 products of the trainer's steps: "highest"/"float32" strict,
        # "high"/"tensorfloat32" TF32 (cuBLAS and cuDNN); the rest raise at
        # trainer build (core.precision.fp32_precision)
        self.matmul_precision = self.choice("highest", "float32", "high", "tensorfloat32", "bfloat16", "default",
                                            "fastest")
        # K steps a compiled call, in the JAX package; the port runs one
        self.steps_per_call = 1
        self.eval_steps_per_call = 0

        # batches pad L to a multiple of length_bucket, at most max_seq_len
        self.max_seq_len = 128
        self.length_bucket = 16

        # the val stage runs each eval epoch where the dataset has a real val
        # split (MOSEI, MOSI, DailyDialog, MMIN folds); --select_on=val picks
        # the best model by val F1 instead of test F1
        self.eval_val = True
        self.select_on = self.choice("test", "val")
        # MOSEI's multilabel emotion block (CIM's test stage); "" elsewhere
        self.mosei_metric = "multiemo"

        # serving builds no optimizer: the settings are only carried
        self.optim = Params(name="Adam", lr=1e-3, weight_decay=0.0)

    @property
    def n_classes(self) -> int:
        return round(float(self.dataset.split("-")[-1]))

    def iparams(self):
        super().iparams()
        ds = self.dataset
        if "mosei" not in ds:
            self.mosei_metric = ""
        if "iemocap" in ds or ("synthetic" in ds and "cogmen" in ds):
            if self.n_classes == 4:
                self.class_names = ["hap", "sad", "neu", "ang"]
            elif self.n_classes == 6:
                self.class_names = ["hap", "sad", "neu", "ang", "exc", "fru"]
            if "cogmen" in ds or "synthetic" in ds:
                self.hidden_audio = 100
                self.hidden_text = 100
                self.hidden_visual = 512
        elif "meld" in ds:
            self.class_names = [
                "neutral", "sad", "mad", "scared", "powerful", "peaceful", "joyful"
            ]
            self.n_speakers = 9
            if "mmgcn" in ds or "synthetic" in ds:
                self.hidden_audio = 300
                self.hidden_text = 600
                self.hidden_visual = 342
        elif "mosei" in ds:
            self.class_names = ["hap", "sad", "disgust", "fear", "surprise", "ang"]
            self.hidden_text = 300
            self.hidden_audio = 74
            self.hidden_visual = 35

        if "pad80" in ds:
            self.hidden_audio = 80
        elif "fbank" in ds:
            self.hidden_audio = 640
        elif "is10" in ds:
            self.hidden_audio = 1584

        if "sbert" in ds or "robert" in ds:
            self.hidden_text = 768

        if "tsn" in ds:
            if "v+" in ds:
                self.hidden_visual += 2048
            else:
                self.hidden_visual = 2048

        self.hidden_all = 0
        if "t" in self.modality:
            self.hidden_all += self.hidden_text
        if "a" in self.modality:
            self.hidden_all += self.hidden_audio
        if "v" in self.modality:
            self.hidden_all += self.hidden_visual
