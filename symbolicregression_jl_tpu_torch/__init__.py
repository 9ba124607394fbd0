"""PyTorch port of the symbolic regression framework.

The ``equation_search`` / ``SRRegressor`` paths of ``symbolicregression_jl_tpu``
in PyTorch (the lockstep scheduler and the device-resident engine, with
checkpoints, ``resume_from`` and fault injection): host regularized evolution over
island populations, batched scoring through a hand-written CUDA fused
eval+loss kernel (``csrc/fused_loss.cu``), batched constant optimization
through the interpreter's reverse-sweep gradient, and a complexity-indexed
hall of fame. ``fleet_search`` (models/device_search.py) and
``multitarget_search`` run many device-engine searches as one, sharing each
kernel launch across them. Entry points run on ``cuda`` unless the caller
asks for the CPU (``Options(device="cpu")``). The package imports nothing of the JAX
package; ``convert.py`` carries state across from it as numpy arrays.
"""

from .dataset import Dataset
from .options import MutationWeights, Options
from .regressor import MultitargetSRRegressor, SRRegressor
from .search import SearchResult, equation_search
from .tree import Node, binary, constant, feature, unary
from .models.hall_of_fame import HallOfFame
from .models.population import Population
from .models.pop_member import PopMember
from .ops import (
    OperatorSet,
    eval_trees,
    eval_trees_with_ok,
    flatten_trees,
    resolve_operators,
)
# the loss zoo's re-exports, as the JAX root has them (the reference
# re-exports the LossFunctions.jl names, SymbolicRegression.jl
# src/SymbolicRegression.jl:101-127): accepted by
# Options(elementwise_loss=...), by object or by string ("LPDistLoss(3)")
from .ops.losses import (
    DWDMarginLoss,
    ExpLoss,
    HuberLoss,
    L1DistLoss,
    L1EpsilonInsLoss,
    L1HingeLoss,
    L2DistLoss,
    L2EpsilonInsLoss,
    L2HingeLoss,
    L2MarginLoss,
    LogCoshLoss,
    LogisticLoss,
    LogitDistLoss,
    LogitMarginLoss,
    LPDistLoss,
    ModifiedHuberLoss,
    PerceptronLoss,
    PeriodicLoss,
    QuantileLoss,
    SigmoidLoss,
    SmoothedL1HingeLoss,
    ZeroOneLoss,
    loss_zoo,
    make_loss,
)
from .analysis.ir_verify import FlatIRError, verify_flat_trees
from .utils.checkpoint import (
    CheckpointError,
    SearchCheckpoint,
    SearchCheckpointer,
    latest_checkpoint,
    load_checkpoint,
    load_saved_state,
)
# many targets over one X as one fleet of device-engine lanes
from .stream import MultitargetSearch, multitarget_search

__version__ = "0.1.0"

__all__ = [
    "Dataset",
    "MutationWeights",
    "MultitargetSRRegressor",
    "Options",
    "SRRegressor",
    "SearchResult",
    "equation_search",
    "Node",
    "binary",
    "constant",
    "feature",
    "unary",
    "HallOfFame",
    "Population",
    "PopMember",
    "OperatorSet",
    "eval_trees",
    "eval_trees_with_ok",
    "flatten_trees",
    "resolve_operators",
    "load_saved_state",
    "CheckpointError",
    "FlatIRError",
    "SearchCheckpoint",
    "SearchCheckpointer",
    "latest_checkpoint",
    "load_checkpoint",
    "verify_flat_trees",
    "DWDMarginLoss",
    "ExpLoss",
    "HuberLoss",
    "L1DistLoss",
    "L1EpsilonInsLoss",
    "L1HingeLoss",
    "L2DistLoss",
    "L2EpsilonInsLoss",
    "L2HingeLoss",
    "L2MarginLoss",
    "LogCoshLoss",
    "LogitDistLoss",
    "LogitMarginLoss",
    "LPDistLoss",
    "ModifiedHuberLoss",
    "PerceptronLoss",
    "PeriodicLoss",
    "QuantileLoss",
    "SigmoidLoss",
    "SmoothedL1HingeLoss",
    "ZeroOneLoss",
    "LogisticLoss",
    "loss_zoo",
    "make_loss",
    "MultitargetSearch",
    "multitarget_search",
    "__version__",
]
