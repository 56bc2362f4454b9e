"""Browser demo UI (stands in for the reference's Gradio app,
``infer/infer_gradio.py`` — gradio is not in this image, and a static page
against the JSON API serves the same product purpose: type text, pick a voice,
listen).

Copy of ``f5tts_tpu/serve/webui.py``; ``serve/server.py`` serves it at ``/app``."""

PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>f5tts-tpu</title>
<style>
 body { font-family: system-ui, sans-serif; max-width: 720px; margin: 2rem auto; padding: 0 1rem; }
 textarea { width: 100%; height: 6rem; font-size: 1rem; }
 select, input, button { font-size: 1rem; margin: 0.3rem 0.3rem 0.3rem 0; }
 #status { color: #666; margin-left: 0.6rem; }
 .row { margin: 0.6rem 0; }
</style></head>
<body>
<h2>f5tts-tpu — Indic TTS</h2>
<div class="row"><textarea id="text" placeholder="Type text to speak...">Hello! This speech was synthesized on a TPU.</textarea></div>
<div class="row" id="styles" style="color:#666">multi-style: </div>
<div class="row" id="descrow" style="display:none">
 style description <input id="desc" placeholder="A calm female speaker..." style="width:70%"
  title="parler branch: conditions the voice on a text description instead of reference audio">
</div>
<div class="row">
 voice <select id="voice"></select>
 nfe <input id="nfe" type="number" placeholder="auto" min="1" max="128" style="width:4.5rem"
  title="model evals per guidance branch; blank = the server's certified default">
 cfg <input id="cfg" type="number" value="2.0" step="0.5" style="width:4.5rem">
 speed <input id="speed" type="number" value="1.0" step="0.1" style="width:4.5rem">
 seed <input id="seed" type="number" placeholder="rand" style="width:5rem">
 key <input id="apikey" type="password" placeholder="api key" style="width:7rem" title="sent as Authorization: Bearer (only needed when the server enforces F5TPU_API_KEY)">
</div>
<div class="row"><button id="go">Synthesize</button><span id="status"></span></div>
<div class="row"><audio id="player" controls style="width:100%"></audio></div>
<hr>
<h3>Voice chat</h3>
<p style="color:#666">Speak, transcribe (local Whisper weights required), reply through TTS — the
reference Gradio app's voice-chat tab (`infer_gradio.py:534-739`) as a browser flow.</p>
<div class="row">
 <button id="rec">● Record</button>
 <span id="vstatus"></span>
</div>
<div class="row"><audio id="vplayer" controls style="width:100%"></audio></div>
<hr>
<h3>Voice slots</h3>
<p style="color:#666">Upload reference voices (≤100 slots) with their transcripts — the Gradio
app's multi-style voice-slot management (`infer_gradio.py:317-499`) as API + UI.</p>
<div class="row">
 name <input id="vname" placeholder="narrator_f" style="width:10rem">
 wav <input id="vfile" type="file" accept=".wav,audio/wav">
 ref text <input id="vreftext" placeholder="what the clip says" style="width:30%">
 <button id="vadd">Add voice</button><span id="vmgmt"></span>
</div>
<div class="row" id="vlist" style="color:#666"></div>
<hr>
<h3>Custom checkpoint</h3>
<p style="color:#666">Hot-swap the served model (the Gradio app's custom-ckpt picker,
`infer_gradio.py:751-819`); the last-used paths are remembered server-side.</p>
<div class="row"><input id="ckpt" placeholder="DiT checkpoint (.pt/.safetensors)" style="width:100%"></div>
<div class="row"><input id="vocab" placeholder="vocab.txt" style="width:49%">
 <input id="vocoder" placeholder="vocos checkpoint" style="width:49%"></div>
<div class="row"><button id="loadmodel">Load model</button><span id="mstatus"></span></div>
<script>
function authH(extra) {
  const k = document.getElementById('apikey').value || localStorage.getItem('f5tpu_key') || '';
  if (document.getElementById('apikey').value) localStorage.setItem('f5tpu_key', document.getElementById('apikey').value);
  const h = extra || {};
  if (k) h['Authorization'] = 'Bearer ' + k;
  return h;
}
window.addEventListener('DOMContentLoaded', () => {
  const saved = localStorage.getItem('f5tpu_key');
  if (saved) document.getElementById('apikey').value = saved;
});
</script>
<script>
async function loadModelInfo() {
  try {
    const m = await (await fetch('/v1/model', {headers: authH()})).json();
    const last = m.last_used || {};
    document.getElementById('ckpt').value = m.tts_ckpt || last.tts_ckpt || '';
    document.getElementById('vocab').value = m.tts_vocab || last.tts_vocab || '';
    document.getElementById('vocoder').value = m.vocoder_ckpt || last.vocoder_ckpt || '';
    if (m.demo_tiny) document.getElementById('mstatus').textContent = 'serving: demo-tiny';
    if (m.tts_model === 'parler') {
      // parler branch: description conditioning, no reference voices
      document.getElementById('descrow').style.display = '';
      document.getElementById('voice').disabled = true;
    }
  } catch (e) {}
}
document.getElementById('loadmodel').onclick = async () => {
  const st = document.getElementById('mstatus');
  st.textContent = 'loading (first compile can take minutes)...';
  const body = {
    tts_ckpt: document.getElementById('ckpt').value,
    tts_vocab: document.getElementById('vocab').value,
    vocoder_ckpt: document.getElementById('vocoder').value,
  };
  const r = await fetch('/v1/load_model', {method:'POST', headers: authH({'content-type':'application/json'}), body: JSON.stringify(body)});
  st.textContent = r.ok ? 'loaded' : 'error: ' + (await r.text());
};
loadModelInfo();
</script>
<script>
// Capture raw PCM via WebAudio and encode WAV client-side: MediaRecorder can
// only produce webm/ogg opus, which the server's WAV reader (audio/io.py)
// does not decode — no browser emits WAV from MediaRecorder.
let recState = null;
function encodeWav(samples, rate) {
  const buf = new ArrayBuffer(44 + samples.length * 2), v = new DataView(buf);
  const s = (o, t) => { for (let i = 0; i < t.length; i++) v.setUint8(o + i, t.charCodeAt(i)); };
  s(0, 'RIFF'); v.setUint32(4, 36 + samples.length * 2, true); s(8, 'WAVEfmt ');
  v.setUint32(16, 16, true); v.setUint16(20, 1, true); v.setUint16(22, 1, true);
  v.setUint32(24, rate, true); v.setUint32(28, rate * 2, true);
  v.setUint16(32, 2, true); v.setUint16(34, 16, true);
  s(36, 'data'); v.setUint32(40, samples.length * 2, true);
  for (let i = 0; i < samples.length; i++) {
    const x = Math.max(-1, Math.min(1, samples[i]));
    v.setInt16(44 + i * 2, x < 0 ? x * 32768 : x * 32767, true);
  }
  return new Blob([buf], {type: 'audio/wav'});
}
document.getElementById('rec').onclick = async () => {
  const btn = document.getElementById('rec'), st = document.getElementById('vstatus');
  if (recState) {
    const {ctx, proc, src, stream, chunks} = recState; recState = null;
    proc.disconnect(); src.disconnect(); stream.getTracks().forEach(t => t.stop());
    btn.textContent = '● Record'; st.textContent = 'thinking...';
    const n = chunks.reduce((a, c) => a + c.length, 0);
    const samples = new Float32Array(n);
    let off = 0; for (const c of chunks) { samples.set(c, off); off += c.length; }
    const rate = ctx.sampleRate; await ctx.close();
    const fd = new FormData();
    fd.append('file', encodeWav(samples, rate), 'input.wav');
    const r = await fetch('/v1/speech_to_speech', {method: 'POST', headers: authH(), body: fd});
    if (!r.ok) { st.textContent = 'error: ' + (await r.text()); return; }
    const blob = await r.blob();
    document.getElementById('vplayer').src = URL.createObjectURL(blob);
    document.getElementById('vplayer').play();
    st.textContent = '';
    return;
  }
  try {
    const stream = await navigator.mediaDevices.getUserMedia({audio: true});
    const ctx = new AudioContext();
    const src = ctx.createMediaStreamSource(stream);
    const proc = ctx.createScriptProcessor(4096, 1, 1);
    const chunks = [];
    proc.onaudioprocess = e => chunks.push(new Float32Array(e.inputBuffer.getChannelData(0)));
    src.connect(proc); proc.connect(ctx.destination);
    recState = {ctx, proc, src, stream, chunks};
    btn.textContent = '■ Stop'; st.textContent = 'recording...';
  } catch (e) { st.textContent = 'mic error: ' + e; }
};
</script>
<script>
async function loadVoices() {
  try {
    const h = await (await fetch('/v1/voices', {headers: authH()})).json();
    const sel = document.getElementById('voice');
    const styles = document.getElementById('styles');
    for (const v of h.voices) {
      const o = document.createElement('option'); o.value = v; o.textContent = v; sel.appendChild(o);
      // multi-style segmented generation (the Gradio app's multi-style tab,
      // infer_gradio.py:317-499): a {Voice} tag in the text switches the
      // reference voice for everything after it
      const b = document.createElement('button'); b.textContent = '{' + v + '}';
      b.title = 'insert style tag: text after this tag is spoken by ' + v;
      b.onclick = () => {
        const t = document.getElementById('text');
        const at = t.selectionStart ?? t.value.length;
        t.value = t.value.slice(0, at) + '{' + v + '} ' + t.value.slice(at);
        t.focus();
      };
      styles.appendChild(b);
    }
    renderVoiceSlots(h.voices);
  } catch (e) {}
}
function renderVoiceSlots(voices) {
  const list = document.getElementById('vlist');
  list.textContent = 'slots: ';
  for (const v of voices) {
    const span = document.createElement('span');
    span.style.marginRight = '0.6rem';
    span.textContent = v + ' ';
    const del = document.createElement('button');
    del.textContent = '×'; del.title = 'delete voice slot ' + v;
    del.onclick = async () => {
      const r = await fetch('/v1/voices/' + encodeURIComponent(v), {method:'DELETE', headers: authH()});
      const body = await r.json();
      document.getElementById('vmgmt').textContent = r.ok ? 'deleted ' + v : (body.error || 'error');
      if (r.ok) refreshVoiceControls(body.voices);
    };
    span.appendChild(del);
    list.appendChild(span);
  }
}
function refreshVoiceControls(voices) {
  const sel = document.getElementById('voice');
  sel.innerHTML = '';
  for (const v of voices) {
    const o = document.createElement('option'); o.value = v; o.textContent = v; sel.appendChild(o);
  }
  renderVoiceSlots(voices);
}
document.getElementById('vadd').onclick = async () => {
  const st = document.getElementById('vmgmt');
  const f = document.getElementById('vfile').files[0];
  const name = document.getElementById('vname').value.trim();
  if (!f || !name) { st.textContent = 'need a name and a wav file'; return; }
  const fd = new FormData();
  fd.append('name', name);
  fd.append('ref_text', document.getElementById('vreftext').value);
  fd.append('file', f, f.name);
  const r = await fetch('/v1/voices', {method:'POST', headers: authH(), body: fd});
  const body = await r.json();
  st.textContent = r.ok ? 'added ' + name : (body.error || 'error');
  if (r.ok) refreshVoiceControls(body.voices);
};
document.getElementById('go').onclick = async () => {
  const status = document.getElementById('status');
  status.textContent = 'synthesizing...';
  const body = {
    text: document.getElementById('text').value,
    voice: document.getElementById('voice').value || null,
    nfe_step: document.getElementById('nfe').value ? parseInt(document.getElementById('nfe').value) : null,
    cfg_strength: parseFloat(document.getElementById('cfg').value),
    speed: parseFloat(document.getElementById('speed').value),
  };
  const seed = document.getElementById('seed').value;
  if (seed !== '') body.seed = parseInt(seed);
  const desc = document.getElementById('desc').value;
  if (desc) body.description = desc;
  const t0 = performance.now();
  const r = await fetch('/v1/audio/speech', {method:'POST', headers: authH({'content-type':'application/json'}), body: JSON.stringify(body)});
  if (!r.ok) { status.textContent = 'error: ' + (await r.text()); return; }
  const blob = await r.blob();
  document.getElementById('player').src = URL.createObjectURL(blob);
  document.getElementById('player').play();
  status.textContent = ((performance.now()-t0)/1000).toFixed(2) + 's';
};
loadVoices();
</script>
</body></html>"""
