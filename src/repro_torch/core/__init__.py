"""DeEPCA core in PyTorch: the port's counterpart of ``repro.core``."""
from .topology import (DisconnectedTopologyError, Topology, complete,
                       erdos_renyi, from_adjacency, hypercube,
                       make_topology, ring, torus2d, validate_mixing)
from .mixing import (agent_mean, consensus_error, fastmix, fastmix_eta,
                     fastmix_wire, fastmix_wire_ef, naive_mix)
from .consensus import (BACKENDS, VARIANTS, ConsensusEngine,
                        DynamicConsensusEngine, Window, resolve_backend)
from .schedule import TopologySchedule, adjacency_of
from .operators import (StackedOperators, libsvm_like,
                        synthetic_problem_batch, synthetic_spiked,
                        top_k_eigvecs)
from .step import (PowerStep, qr_orth, rebase_carry, sign_adjust,
                   split_state)
from .driver import BatchRun, DriverRun, IterationDriver, local_apply
from .collectives import (AgentError, Timeline, Transport,
                          choose_transport, spawn_agents)
from .gossip_shard import (DistributedDeEPCA, fastmix_local,
                           hypercube_structure, make_round_fn,
                           ring_structure)
from .algorithms import (DecentralizedPCAResult, PowerTrace,
                         centralized_power_method, collect_trace, deepca,
                         depca, resolve_acceleration, resolve_engines,
                         theory_consensus_rounds)
from . import metrics

__all__ = [
    "Topology", "ring", "torus2d", "hypercube", "complete", "erdos_renyi",
    "from_adjacency", "make_topology", "validate_mixing",
    "DisconnectedTopologyError",
    "fastmix", "fastmix_wire", "fastmix_wire_ef", "naive_mix", "fastmix_eta",
    "consensus_error", "agent_mean",
    "ConsensusEngine", "DynamicConsensusEngine", "Window",
    "resolve_backend", "BACKENDS", "VARIANTS",
    "TopologySchedule", "adjacency_of",
    "StackedOperators", "synthetic_spiked", "synthetic_problem_batch",
    "libsvm_like", "top_k_eigvecs",
    "PowerStep", "qr_orth", "rebase_carry", "sign_adjust", "split_state",
    "IterationDriver", "DriverRun", "BatchRun", "local_apply",
    "spawn_agents", "Transport", "Timeline", "AgentError",
    "choose_transport", "DistributedDeEPCA", "make_round_fn",
    "fastmix_local", "ring_structure", "hypercube_structure",
    "deepca", "depca", "centralized_power_method", "collect_trace",
    "resolve_engines", "resolve_acceleration",
    "DecentralizedPCAResult", "PowerTrace", "theory_consensus_rounds",
    "metrics",
]
