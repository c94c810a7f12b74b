"""Disruption orchestration queue (reference: disruption/queue.go:313-391):
taint candidates, mark claims Disrupted, create replacement NodeClaims, and
delete the candidates only when every replacement is Initialized.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ...apis import labels as wk
from ...apis.nodeclaim import COND_DISRUPTION_REASON
from ...scheduling.taints import NO_SCHEDULE, Taint
from .types import Command

DISRUPTED_TAINT = Taint(key=wk.DISRUPTED_TAINT_KEY, effect=NO_SCHEDULE)


@dataclass
class _Item:
    command: Command
    replacement_names: list[str] = field(default_factory=list)


class OrchestrationQueue:
    def __init__(self, store, cluster, provisioner, clock, recorder=None):
        self.store = store
        self.cluster = cluster
        self.provisioner = provisioner
        self.clock = clock
        self.recorder = recorder
        self._items: list[_Item] = []

    def disrupting_names(self) -> set[str]:
        return {name for item in self._items for name in item.command.candidate_names()}

    def start_command(self, command: Command) -> bool:
        """Taint + mark + create replacements (queue.go StartCommand)."""
        # taint all candidates NoSchedule and mark for deletion in state
        for c in command.candidates:
            node_name = c.name()

            def taint(n):
                if not any(t.key == wk.DISRUPTED_TAINT_KEY for t in n.spec.taints):
                    n.spec.taints.append(DISRUPTED_TAINT)

            node = self.store.try_get("Node", node_name)
            if node is None:
                return False
            self.store.patch("Node", node_name, taint)
            if c.node_claim is not None:
                def mark(nc):
                    nc.status.conditions.set_true(COND_DISRUPTION_REASON, reason=command.reason, now=self.clock.now())

                try:
                    self.store.patch("NodeClaim", c.node_claim.metadata.name, mark)
                except Exception as e:
                    # losing the DisruptionReason condition is benign (the
                    # claim may have been deleted out from under the command)
                    # but never silent: the event stream records it
                    if self.recorder is not None:
                        self.recorder.publish(c.node_claim, "DisruptionQueueError", f"marking Disrupted failed: {e}", type_="Warning")
        self.cluster.mark_for_deletion([c.state_node.provider_id() for c in command.candidates])

        item = _Item(command=command)
        for replacement in command.replacements:
            name = self.provisioner.create_node_claim(replacement, reason=command.reason or "provisioning")
            if name is None:
                self._rollback(command, created=item.replacement_names)
                return False
            item.replacement_names.append(name)
        self._items.append(item)
        return True

    def reconcile(self) -> None:
        """Advance in-flight commands; delete candidates once replacements are
        Initialized (queue.go:186-256)."""
        remaining = []
        for item in self._items:
            ready = True
            for name in item.replacement_names:
                nc = self.store.try_get("NodeClaim", name)
                if nc is None:
                    # replacement failed/was GC'd: roll the command back,
                    # removing the other replacements too
                    self._rollback(item.command, created=[n for n in item.replacement_names if n != name])
                    ready = None
                    break
                if not nc.is_initialized():
                    ready = False
            if ready is None:
                continue
            if not ready:
                remaining.append(item)
                continue
            for c in item.command.candidates:
                if c.node_claim is not None:
                    self.store.try_delete("NodeClaim", c.node_claim.metadata.name)
                else:
                    self.store.try_delete("Node", c.name())
        self._items = remaining

    def _rollback(self, command: Command, created: list[str] | None = None) -> None:
        """Undo a failed command: untaint + unmark candidates, clear their
        DisruptionReason condition, and delete any replacements already
        created (controller.go:159 ClearNodeClaimsCondition)."""
        for c in command.candidates:
            def untaint(n):
                n.spec.taints = [t for t in n.spec.taints if t.key != wk.DISRUPTED_TAINT_KEY]

            node = self.store.try_get("Node", c.name())
            if node is not None:
                self.store.patch("Node", c.name(), untaint)
            if c.node_claim is not None:
                def clear(nc):
                    nc.status.conditions.clear(COND_DISRUPTION_REASON)

                try:
                    self.store.patch("NodeClaim", c.node_claim.metadata.name, clear)
                except Exception as e:
                    # same contract as start_command's mark: benign (claim
                    # may be concurrently deleted), but recorded, not silent
                    if self.recorder is not None:
                        self.recorder.publish(c.node_claim, "DisruptionQueueError", f"clearing DisruptionReason failed: {e}", type_="Warning")
        self.cluster.unmark_for_deletion([c.state_node.provider_id() for c in command.candidates])
        for name in created or []:
            self.store.try_delete("NodeClaim", name)
