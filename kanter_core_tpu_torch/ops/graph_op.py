"""Graph op: a nested graph on the per-node route.

Port of `kanter_core_tpu/ops/graph_op.py` (`vismut_core/src/node/graph.rs`):
the node's embedded `NodeGraph` runs as a throwaway `LiveGraph` on the
same `TextureProcessor`; outer input slot n feeds inner Input node n
(`graph.rs:25-31`, `node_graph.rs:271-313`); the worker blocks until every
inner Output node is clean and re-keys its data as `(outer node id,
SlotId(inner output node id))` (`graph.rs:37-48`). The nested live graph
is removed from the processor when done.
"""

from __future__ import annotations

from ..ids import NodeId, SlotId
from ..slot_data import SlotData


def process(slot_datas, node, tex_pro):
    from ..live_graph import LiveGraph

    live_graph = LiveGraph(tex_pro.buffer_queue)
    live_graph.history_capacity = 0  # throwaway per-evaluation graph: no undo
    live_graph.set_node_graph(node.node_type.payload.clone())
    for slot_data in slot_datas:
        live_graph.add_input_slot_data(
            SlotData(NodeId(int(slot_data.slot_id)), SlotId(0), slot_data.image)
        )

    tex_pro.push_live_graph(live_graph)
    try:
        output = []
        for output_node_id in live_graph.output_ids():
            with LiveGraph.await_clean_read(live_graph, output_node_id) as lg:
                for slot_data in lg.node_slot_datas(output_node_id):
                    output.append(
                        SlotData(node.node_id, SlotId(int(output_node_id)), slot_data.image)
                    )
        return output
    finally:
        tex_pro.remove_live_graph(live_graph)
