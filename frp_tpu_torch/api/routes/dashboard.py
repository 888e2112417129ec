"""A self-contained operations dashboard at GET /dashboard (port of
``frp_tpu/api/routes/dashboard.py``; the page names PyTorch where the JAX
one names the TPU).

The platform's primary frontend contract is the reference's React app (our
routes mirror its API surface, so it runs unchanged). This page is the
zero-build fallback: vanilla JS, no CDN, speaking the same endpoints — camera
grid with snapshot polling, live alerts over the Socket.IO WebSocket (a
minimal engine.io v4 client inline), enrollment + compare upload, FL round
demo — covering the reference dashboard's feature set
(frontend/src/App.jsx + FaceUpload.jsx + CameraGrid.jsx).
"""

from __future__ import annotations

from frp_tpu_torch.api.http import Request, Response

PAGE = r"""<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>face-recognition-platform (PyTorch)</title>
<style>
  :root { color-scheme: dark; }
  body { font-family: system-ui, sans-serif; margin: 0; background:#0e1116; color:#dfe3ea; }
  header { padding: 12px 20px; background:#161b24; display:flex; gap:24px; align-items:baseline; }
  header h1 { font-size: 16px; margin: 0; }
  header .stat { font-size: 13px; color:#8b93a3; }
  header .stat b { color:#dfe3ea; }
  main { display:grid; grid-template-columns: 2fr 1fr; gap:16px; padding:16px 20px; }
  section { background:#161b24; border-radius:8px; padding:14px; }
  h2 { font-size:13px; text-transform:uppercase; letter-spacing:.08em; color:#8b93a3; margin:0 0 10px; }
  .grid { display:grid; grid-template-columns:repeat(2,1fr); gap:10px; }
  .cam { position:relative; }
  .cam img { width:100%; border-radius:6px; background:#0a0d12; aspect-ratio:16/9; object-fit:cover; }
  .cam .label { position:absolute; left:8px; bottom:8px; font-size:12px; background:#000a; padding:2px 8px; border-radius:4px; }
  ul#alerts { list-style:none; margin:0; padding:0; max-height:380px; overflow:auto; font-size:13px; }
  ul#alerts li { padding:6px 8px; border-bottom:1px solid #222938; }
  .prio-critical { color:#ff6b6b; } .prio-high { color:#ffb454; }
  .prio-medium { color:#e8d44d; } .prio-low { color:#8b93a3; }
  form { display:flex; flex-direction:column; gap:8px; font-size:13px; }
  input, button { background:#0e1116; color:#dfe3ea; border:1px solid #2a3347; border-radius:5px; padding:6px 10px; }
  button { cursor:pointer; background:#223; }
  button:hover { background:#2a3347; }
  #log { font-family:monospace; font-size:12px; color:#8b93a3; white-space:pre-wrap; max-height:160px; overflow:auto; }
  .row { display:flex; gap:8px; }
</style>
</head>
<body>
<header>
  <h1>face-recognition-platform <span style="color:#5b8def">PyTorch</span></h1>
  <span class="stat">gallery <b id="s-gallery">–</b></span>
  <span class="stat">cameras <b id="s-cameras">–</b></span>
  <span class="stat">socket <b id="s-socket">connecting…</b></span>
</header>
<main>
  <div>
    <section>
      <h2>Cameras</h2>
      <div class="grid" id="cams"></div>
    </section>
    <section style="margin-top:16px">
      <h2>Event log</h2>
      <div id="log"></div>
    </section>
  </div>
  <div>
    <section>
      <h2>Live alerts</h2>
      <ul id="alerts"></ul>
    </section>
    <section style="margin-top:16px">
      <h2>Enroll face</h2>
      <form id="enroll">
        <input name="target" placeholder="person name" required>
        <input type="file" name="file" accept="image/*" required>
        <div class="row">
          <button type="submit">Enroll</button>
          <button type="button" id="compareBtn">Compare only</button>
        </div>
      </form>
    </section>
    <section style="margin-top:16px">
      <h2>Federated demo</h2>
      <div class="row">
        <button id="flUpload">Upload 2 demo clients</button>
        <button id="flAggregate">Aggregate</button>
      </div>
      <div id="flStatus" style="font-size:12px; margin-top:8px; color:#8b93a3"></div>
    </section>
  </div>
</main>
<script>
const log = (m) => {
  const el = document.getElementById('log');
  el.textContent = new Date().toISOString().slice(11,19) + '  ' + m + '\n' + el.textContent;
};

async function refreshStatus() {
  const r = await fetch('/'); const d = await r.json();
  document.getElementById('s-gallery').textContent = d.gallery_size;
  document.getElementById('s-cameras').textContent = d.cameras;
}
async function refreshCams() {
  const r = await fetch('/camera/list'); const d = await r.json();
  const grid = document.getElementById('cams');
  grid.innerHTML = '';
  for (const cam of d.cameras.slice(0, 4)) {
    // textContent, not innerHTML: camera names are operator input via the
    // unauthenticated POST /camera/add (stored XSS otherwise)
    const div = document.createElement('div');
    div.className = 'cam';
    const img = document.createElement('img');
    img.src = `/api/camera/${encodeURIComponent(cam.id)}/snapshot?t=${Date.now()}`;
    const label = document.createElement('span');
    label.className = 'label';
    label.textContent = `${cam.id} · ${cam.name} ${cam.healthy ? '' : '⚠'}`;
    div.append(img, label);
    grid.appendChild(div);
  }
}
function addAlert(a) {
  const li = document.createElement('li');
  li.className = 'prio-' + a.priority;
  li.textContent = `[${a.priority}] ${a.target} @ ${a.camera_name} d=${a.distance}`;
  const ul = document.getElementById('alerts');
  ul.prepend(li);
  while (ul.children.length > 50) ul.removeChild(ul.lastChild);
}

// minimal engine.io v4 / socket.io v5 websocket client
function connectSocket() {
  const ws = new WebSocket(`ws://${location.host}/socket.io/?EIO=4&transport=websocket`);
  ws.onmessage = (ev) => {
    const t = ev.data;
    if (t[0] === '0') { ws.send('40'); return; }          // open -> connect ns
    if (t[0] === '2') { ws.send('3'); return; }            // ping -> pong
    if (t.startsWith('40')) {
      document.getElementById('s-socket').textContent = 'live';
      log('socket connected'); return;
    }
    if (t.startsWith('42')) {
      const [event, data] = JSON.parse(t.slice(2));
      if (event === 'new_alert') addAlert(data);
      log(event + ' ' + JSON.stringify(data).slice(0, 140));
    }
  };
  ws.onclose = () => {
    document.getElementById('s-socket').textContent = 'reconnecting…';
    setTimeout(connectSocket, 3000);
  };
}

document.getElementById('enroll').addEventListener('submit', async (e) => {
  e.preventDefault();
  const form = new FormData(e.target);
  const r = await fetch('/face/upload', { method: 'POST', body: form });
  const d = await r.json();
  log('enroll: ' + JSON.stringify(d).slice(0, 160));
  refreshStatus();
});
document.getElementById('compareBtn').addEventListener('click', async () => {
  const form = new FormData(document.getElementById('enroll'));
  const r = await fetch('/face/compare', { method: 'POST', body: form });
  log('compare: ' + JSON.stringify(await r.json()).slice(0, 200));
});
document.getElementById('flUpload').addEventListener('click', async () => {
  for (const c of ['demo_a', 'demo_b']) {
    await fetch('/face/fl/upload_weights', {
      method: 'POST', headers: {'Content-Type': 'application/json'},
      body: JSON.stringify({client_id: c, weights: {
        layer1: Array.from({length: 8}, Math.random),
        layer2: Array.from({length: 4}, Math.random)}})
    });
  }
  log('uploaded demo client weights');
});
document.getElementById('flAggregate').addEventListener('click', async () => {
  const r = await fetch('/face/fl/aggregate', {method:'POST',
    headers: {'Content-Type':'application/json'}, body: '{}'});
  const d = await r.json();
  document.getElementById('flStatus').textContent = JSON.stringify(d).slice(0, 200);
});

refreshStatus(); refreshCams(); connectSocket();
setInterval(refreshStatus, 5000);
setInterval(refreshCams, 5000);
</script>
</body>
</html>
"""


def register(router, ctx):
    @router.get("/dashboard")
    async def dashboard(request: Request):
        return Response(PAGE.encode(), 200, "text/html; charset=utf-8")
