from pytorchrec_tpu_torch.models.base import RecModel
from pytorchrec_tpu_torch.models.ctr import DLRM, FM, LR, DCNv2, DeepFM
from pytorchrec_tpu_torch.models.din import DIN
from pytorchrec_tpu_torch.models.funk_svd import FunkSVD
from pytorchrec_tpu_torch.models.gru4rec import GRU4Rec
from pytorchrec_tpu_torch.models.ncf import NCF
from pytorchrec_tpu_torch.models.sasrec import SASRec
from pytorchrec_tpu_torch.models.svdpp import SVDPP
from pytorchrec_tpu_torch.models.two_tower import TwoTower

__all__ = ["RecModel", "DCNv2", "DeepFM", "DIN", "DLRM", "FM", "FunkSVD", "GRU4Rec", "LR", "NCF",
           "SASRec", "SVDPP", "TwoTower"]
