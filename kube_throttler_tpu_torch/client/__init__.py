"""Client layer — hand-written analog of the reference's generated API
machinery (pkg/generated/, SURVEY.md §2.2): typed clientset with the full
verb set, watch streams, shared informers with resync + indexers,
indexer-backed listers, a fake clientset for tests, and the wire transport
(list+watch reflectors + remote status writer + mock apiserver) that speaks
the real Kubernetes HTTP protocol (plugin.go:71-130).
"""

from .clientset import (
    Clientset,
    ClusterThrottleInterface,
    CoreV1Client,
    NamespaceInterface,
    PodInterface,
    ScheduleV1alpha1Client,
    ThrottleInterface,
    json_merge_patch,
    new_fake_clientset,
)
from .informers import (
    NAMESPACE_INDEX,
    Indexer,
    InformerBundle,
    SharedIndexInformer,
    SharedInformerFactory,
)
from .listers import (
    ClusterThrottleLister,
    Listers,
    NamespaceLister,
    PodLister,
    ThrottleLister,
)
from .transport import (
    ApiClient,
    ApiError,
    GoneError,
    Reflector,
    RemoteSession,
    RemoteStatusWriter,
    RestConfig,
    parse_kubeconfig,
)
from .watch import Watch

__all__ = [
    "ApiClient",
    "ApiError",
    "Clientset",
    "ClusterThrottleInterface",
    "ClusterThrottleLister",
    "CoreV1Client",
    "GoneError",
    "Indexer",
    "InformerBundle",
    "Listers",
    "NAMESPACE_INDEX",
    "NamespaceInterface",
    "NamespaceLister",
    "PodInterface",
    "PodLister",
    "Reflector",
    "RemoteSession",
    "RemoteStatusWriter",
    "RestConfig",
    "ScheduleV1alpha1Client",
    "SharedIndexInformer",
    "SharedInformerFactory",
    "ThrottleInterface",
    "ThrottleLister",
    "Watch",
    "json_merge_patch",
    "new_fake_clientset",
    "parse_kubeconfig",
]
