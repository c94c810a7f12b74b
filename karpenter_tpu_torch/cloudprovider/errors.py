"""CloudProvider error taxonomy (reference: pkg/cloudprovider/types.go:600-700)."""


class NodeClaimNotFoundError(Exception):
    """The instance behind a NodeClaim no longer exists."""


class InsufficientCapacityError(Exception):
    """Launch failed for lack of capacity; the claim should be retried elsewhere."""


class NodeClassNotReadyError(Exception):
    """The referenced NodeClass is not ready for use."""


class CreateError(Exception):
    def __init__(self, message: str, condition_reason: str = "LaunchFailed"):
        super().__init__(message)
        self.condition_reason = condition_reason
