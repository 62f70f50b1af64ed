"""The trace reduction on a hand-made event list: the union of the
device's work, kernels by name, the benchmark's spans as labels of the
idle gaps, and the device copies of the spans left out of the work."""
from torch.autograd import DeviceType

from port_bench.harness import bench, roofline, trace


class Ev:
    def __init__(self, name, dev, start, end, annotation=False):
        self._n, self._d, self._s, self._e, self._a = name, dev, start, end, annotation

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def is_user_annotation(self):
        return self._a


CPU, GPU = DeviceType.CPU, DeviceType.CUDA
EVENTS = [Ev('bench.chunk', CPU, 0, 1000), Ev('bench.chunk', GPU, 0, 1000, True),
          Ev('models.potential.converged_eval', CPU, 0, 300),
          Ev('md.step_graph.replays', CPU, 300, 1000),
          Ev('aten::mul', CPU, 10, 20),
          Ev('k_a(float*)', GPU, 100, 200), Ev('k_b', GPU, 150, 250), Ev('k_a(float*)', GPU, 400, 900),
          Ev('Memcpy DtoH', GPU, 950, 960)]


def test_reduce_events():
    r = trace.reduce_events(EVENTS, 10, 1e-6)
    assert abs(r['busy_s'] - (150 + 500 + 10) * 1e-9) < 1e-15
    assert abs(r['window_s'] - 1000e-9) < 1e-15
    assert r['n_kernels'] == 3
    assert r['kernels']['k_a'][1] == 2 and abs(r['kernels']['k_a'][0] - 600e-9) < 1e-15
    assert abs(r['kernel_s'] - 700e-9) < 1e-15
    gaps = dict((round(s * 1e9), lab) for lab, s in r['idle_gaps'])
    assert gaps[100] == 'models.potential.converged_eval'     # 0..100
    assert gaps[150] == 'md.step_graph.replays'                # 250..400, mid 325
    assert r['device_ops'][0][0] == 'k_a'
    assert abs(r['span_s']['models.potential.converged_eval'] - 300e-9) < 1e-15


def test_report_edge_share():
    r = trace.reduce_events(EVENTS, 10, 1e-6)
    assert abs(bench.read_metric('report_edge_share.dense', {'trace': r}) - 30.0) < 1e-9
    assert bench.read_metric('report_edge_share.dense', {}) is None


def test_roofline_share():
    k = {'fixed_field_tri_kernel': (2e-3, 1), 'direct_efp_tri_kernel': (1e-3, 1),
         'tile_sum_kernel': (1e-3, 2)}
    b = roofline.dense_bounds(1024, 216468, 1e15)
    s = roofline.share(k, b, ('tile_sum_kernel',))
    assert 0 < s < 100
    assert abs(s - 100 * sum(b.values()) / 4e-3) < 1e-9
    assert roofline.share({}, b, ()) is None
