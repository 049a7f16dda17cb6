"""FL engine — the paper's contribution, in PyTorch (twin of ``repro.core``)."""
from .protocol import (
    FitIns, FitRes, EvaluateIns, EvaluateRes, Parameters, CompressedParameters,
    ClientProperties, pytree_to_parameters, parameters_to_pytree,
    compress_to_wire, wire_to_pytree,
)
from .client import Client, TorchClient
from .server import Server, History, RoundRecord, make_cost_model_for
from .cost_model import (
    CostModel, DeviceProfile, PROFILES, AWS_DEVICE_FARM, AvailabilityTrace,
    ClientCost, link_time_s,
)
from .scheduler import (
    VirtualClock, Arrival, RoundOutcome, RoundPolicy, SyncAll, Deadline,
    BufferedAsync, deadline_feasible,
)
from .compression import (
    UpdateCodec, Int8Codec, NullCodec, TopKCodec, LoRACodec, MixedCodec,
    BandwidthCodecPolicy, Segment, SegmentMap, StructuredUpdate,
    CompressedPsum, fp32_collective_bytes, compress_update, decompress_update,
)
from .population import CohortState, LazyClientPool, Population
from .strategy import (
    Strategy, FedAvg, FedProx, FedTau, tau_from_reference_processor, FedBuffStrategy,
    FedOpt, FedAdam, FedYogi, FedAvgM, STRATEGIES, pseudo_gradient, weighted_mean,
    CostAwareSampling, CostAwareFedAvg,
)
from .rounds import (
    MultiRoundStep, RoundSpec, cohort_dispatch_mask, init_collective_residual,
    make_client_update, make_multi_round_step, make_round_step,
)
