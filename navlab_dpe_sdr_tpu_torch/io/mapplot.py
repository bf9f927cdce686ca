"""HTML map plotting of fix tracks (pygmaps equivalent).

The reference bundles a Google-Maps HTML generator
(pygnss/pythonreceiver/libgnss/pygmaps.py). Google's v2 API is long dead, so
this writes a self-contained Leaflet/OpenStreetMap HTML file instead — same
role: drop a list of LLA fixes, get a browsable track.

The port's own copy of navlab_dpe_sdr_tpu/io/mapplot.py (host code, no
torch); tests/test_torch_hostlayers.py holds its HTML byte-equal to that
module's.
"""

from __future__ import annotations

import json

import numpy as np

from ..libgnss import frames

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<link rel="stylesheet"
 href="https://unpkg.com/leaflet@1.9.4/dist/leaflet.css"/>
<script src="https://unpkg.com/leaflet@1.9.4/dist/leaflet.js"></script>
<style>html,body,#map{{height:100%;margin:0}}</style></head>
<body><div id="map"></div><script>
var pts = {points};
var map = L.map('map').setView(pts.length ? pts[0] : [0, 0], {zoom});
L.tileLayer('https://tile.openstreetmap.org/{{z}}/{{x}}/{{y}}.png',
            {{maxZoom: 19}}).addTo(map);
if (pts.length) {{
  L.polyline(pts, {{color: '{color}', weight: 3}}).addTo(map);
  L.circleMarker(pts[0], {{radius: 6, color: 'green'}})
    .bindPopup('start').addTo(map);
  L.circleMarker(pts[pts.length - 1], {{radius: 6, color: 'red'}})
    .bindPopup('end').addTo(map);
}}
</script></body></html>
"""


def write_track_html(path: str, lla_points=None, ecef_points=None,
                     title: str = "DPE track", color: str = "#0044cc",
                     zoom: int = 17) -> None:
    """Write an HTML map of a fix track.

    lla_points: iterable of (lat_deg, lon_deg[, alt]); or pass ecef_points
    (iterable of ECEF xyz / 8-states).
    """
    if lla_points is None:
        pts = []
        for p in ecef_points:
            lla = frames.ecef_to_lla(np.asarray(p, dtype=np.float64)[:3])
            pts.append([float(lla[0]), float(lla[1])])
    else:
        pts = [[float(p[0]), float(p[1])] for p in lla_points]
    html = _TEMPLATE.format(points=json.dumps(pts), title=title,
                            color=color, zoom=zoom)
    with open(path, "w") as fo:
        fo.write(html)


def write_fixes_html(path: str, fixes, **kw) -> None:
    """Map a list of DPEFix objects."""
    write_track_html(path, ecef_points=[f.x_ecef for f in fixes], **kw)
