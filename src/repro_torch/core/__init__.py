"""The Scylla core, copied from the reference (jax-free): Mesos-style
resource offers, DRF, placement policies, gang scheduling, the job
simulator and the serving-churn simulator the autoscaler is tested on."""
from . import hw
from .cluster import Cluster, ClusterSpec
from .costmodel import PlacementView, analytic_profile, job_profile, step_time
from .drf import DRFAllocator
from .jobs import JobPhase, JobSpec, JobState, RooflineProfile
from .policies import (AutoPolicy, MinHostPolicy, Placement, SpreadPolicy,
                       get_policy)
from .resources import AgentInfo, Offer, ResourceSpec
from .scheduler import ScyllaScheduler
from .simulator import Simulator

__all__ = [
    "hw", "Cluster", "ClusterSpec", "DRFAllocator", "JobPhase", "JobSpec",
    "JobState", "RooflineProfile", "AutoPolicy", "MinHostPolicy",
    "SpreadPolicy", "Placement", "get_policy", "AgentInfo", "Offer",
    "ResourceSpec", "ScyllaScheduler", "Simulator", "PlacementView",
    "analytic_profile", "job_profile", "step_time",
]
